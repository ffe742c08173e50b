#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed S] [--profile]

Phases, each fatal on failure:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every CUDA kernel from `src/repro_torch/csrc/` (one nvcc per
     source, all in parallel) into `build/repro_torch/`;
  2. hold each kernel against its plain PyTorch version on the card:
     split_scan at n=2^20 (T=2, m=3, L1 in {2, 65, 513}; gini, entropy,
     variance; ties, ragged n) and at L1 = 16,385 and 32,769 (n=2^18-37,
     per-leaf state past a block's shared memory: phase 3's, then both
     phases'); cat_hist at n=2^20 (m=8, V in {2, 1000, 10000}, L1 in
     {2, 65}); feat_hist at n=2^20-37 (m=8, uint8 bins with B=255 and
     uint16 with B=1024, W in {2, 65, 257}, slots with zeros,
     classification and regression); breiman on cat_hist tables of
     n=2^20 rows (V in {2, 40, 300, 1000, 10000}, gini and entropy,
     min_records 0, 1 and 200, every leaf a candidate or about 10 of 82)
     and on random tables of 5 and 20 classes and of 20,000 and 40,000
     categories (gains bit-equal, masks equal wherever the gain is finite,
     the device counter up by the candidates); a depth-16 exact fit on 2^18 noisy
     numeric rows that must reach a padded frontier of 8192 (and grow the
     same trees twice); then every kernel at its main path's shapes with
     its times (CUDA events, median of several runs); split_scan,
     cat_hist and breiman on the inputs of every level of one tree batch
     of the exact fit of phase 3, each held against its plain version
     (bit-equal) and timed; feat_hist on the inputs of every level of one
     tree batch of fit (b) below; the Poisson bag kernel at 2^23 rows (T
     = 1 and 2) and 3·2^24 (T = 1), bit-equal to the plain loop on the
     card and timed beside it and its bound, and its log equal to
     torch.log over all 2^23 uniforms (`--bag` runs phases 0, 1 and this
     check alone);
  3. train `RandomForest(TreeParams(max_depth=10, backend="kernel"),
     num_trees=4, tree_batch=2)` on 2^23 Leo-shaped rows (3 numeric + 79
     categorical columns, arities log-spaced 2..10,000) made with numpy
     from --seed, with the launch counters set to 0 just before and read
     just after (split_scan, cat_hist, breiman and bagging must launch;
     the share of segments breiman scored is printed); a second identical
     fit must grow identical trees;
  4. predict 2^20 held-out rows, print the AUC, check a save/load round
     trip, check that small fits on the card (exact, and hist with
     subtraction, classification and regression; entropy on the kernel
     and the default segment backend) equal the same fits on the CPU, and
     that repeated small regression fits on the card are identical;
  5. hist mode on the card, `TreeParams(max_depth=10, backend="kernel",
     split_mode="hist", num_bins=255)`, 4 trees, tree_batch=2, subtraction
     on, each fit with the counters set to 0 just before and read just
     after, repeated and compared: (a) the Leo-shaped rows of phase 3
     (feat_hist + cat_hist; held-out AUC), (b) 2^23 rows of the paper's
     "majority" family, 6 informative + 10 useless numeric columns
     (feat_hist alone; per-level times and table bytes);
  6. the reference's default path, each fit with its counters set to 0
     just before and read just after, repeated and compared: (a)
     `TreeParams(max_depth=10)` (the `segment` backend, no split_scan
     launch allowed; cat_hist must launch) on phase 3's rows, whose trees
     must equal phase 3's kernel trees; (b) the same on phase 5's majority
     rows, equal to phase 5's exact kernel fit; (c) pruned fits
     (`prune_closed_frac=0.05`, `min_records=32768` so leaves close by
     depth 8) of the Leo rows, exact segment and hist with subtraction,
     that must drop rows and equal the unpruned fits; (d) multinomial bag
     counts of 4 trees x 2^23 rows, card == CPU bit for bit, and a
     multinomial fit; (e) the seed builder `build_tree_reference` on
     2^18 Leo rows (depth 8) == that tree of `build_forest`; (f) (a)'s
     feature importances;
  7. out-of-core streamed training of phase 5 (b)'s rows and params: (a)
     build a `MemmapRowSource` cache under build/repro_torch/stream/
     (deleted at the end), whose edges and bins must equal the in-memory
     quantizer's; (b) `fit_streamed` at chunk_size 2^20 (and a repeat) and
     2^16, each with the counters set to 0 just before and read just
     after: the trees must equal phase 5 (b)'s, feat_hist must launch once
     per chunk of every table level, and feat_hist is held bit-equal to
     its plain version on a chunk of the deepest level captured from the
     fit; walls, per-level walls and peak device memory (the driver's
     host parts are the `stream.*` and `level.book` ranges of a
     `--profile` run); (c)
     `bagging="none"` fits of n/2 and n rows at chunk 2^20, whose peaks
     must differ by less than 64 MiB; (d) the 2^20 fit in a subprocess
     with `checkpoint_dir`, killed by SIGKILL after its third level
     snapshot, then `resume=True` here, which must grow (b)'s trees;
  8. boosted trees, `GBTModel(GBTParams(...)).fit` on phase 3's rows (20
     rounds, depth 4, all 82 columns candidates), each fit with the launch
     and level-step counters set to 0 just before and read just after,
     each kernel of its path launched once per level step and no other:
     (a) `loss="logistic"` (segment: cat_hist), (b) the same with
     `backend="kernel"` (split_scan, cat_hist), (c) `split_mode="hist"`
     (feat_hist, cat_hist), (d) `loss="squared"` on `regression_target`
     (cat_hist); a repeat fit must grow identical rounds, each kernel is
     held against its plain version on the repeat's deepest level of the
     last round, and the held-out AUC must pass 0.6 (MSE fall below the
     prior's); (e) 5-round fits of a 2^16-row cut (logistic, squared,
     `min_records=10`) whose rounds and `predict_raw` equal the CPU's;
  9. serving: phase 3's forest saved to build/repro_torch/serve/ (deleted
     at the end) and loaded by `ForestServer.load` on the card, warmed at
     batch 1 and 1024: (a) answers for 1, 1024 and 2^16 held-out rows
     equal the CPU `PackedForest`'s; (b) every malformed-request class
     raises `InvalidRequest` and the next valid request answers as
     before; (c) the first call after load, single-row p50/p99 over 300
     calls, rows/s at batch 1024 and 2^16; (d) fit 8 (a)'s `predict_raw`:
     single-row p50/p99 and 2^20 rows, equal to the CPU's.
  10. sharded training across ranks: DIST_WORLD = 4 worker processes
     (this script with --dist-worker), all on this card over gloo, meet
     through a FileStore under build/repro_torch/dist/ (deleted after),
     make the rows from --seed as this process does and fit through the
     port's entry points with the mesh engines of
     `repro_torch.core.distributed`, each fit with the counters set to 0
     just before and read just after: (a) phase 6 (a)'s Leo fit on a
     (data=2, model=1) mesh of ranks 0 and 1 (`ShardedExactNumeric`
     segment + `ShardedCategorical`; cat_hist once a level on every rank,
     no split_scan); (b) phase 5 (b)'s hist fit on (2, 2)
     (`ShardedHistNumeric`; feat_hist once a level; each level's
     all-reduce bytes must equal `LevelStats.hist_table_bytes` / 2); (c)
     the majority rows exact on (2, 2) (the resumable 2-D scan); (d)
     `fit_streamed` of (b)'s rows from an `ArrayRowSource` at chunk 2^20
     on (2, 2) (feat_hist once a table chunk); (e) a regression hist fit
     of the majority rows (`regression_target`) on (2, 2) against this
     process's local fit, bit for bit; (f) `make_sharded_evaluate` at
     2^23 rows on (1, 4) against local evaluation.  Every rank's trees
     must equal the local fit's ((a) == phase 6 (a), (b) and (d) ==
     phase 5 (b), (c) == phase 5's exact majority fit).  In (a), (b),
     (d) and (e) each rank keeps the inputs of one call of the table
     wrapper as its engine made it (its shard's rows and columns; in
     (e) the global scales with `fixed=True`) and holds cat_hist or
     feat_hist there against its plain version, bit for bit.  Each rank
     prints its digests, walls, launches, peak device memory and each
     collective's bytes and seconds per level; the ranks share the card
     in time, so no wall here is a speed-up.  Then
     `multihost_smoke.main(2)` runs at its default device, the card.
     `--dist` runs phase 1, the local fits and phase 10 alone.
  11. LM serving (`repro_torch.models`, `serve.engine`'s LM half), weights
     drawn from --seed on the card, float32 TF32 off unless said: (a)
     every registered architecture's reduced variant, `prefill_step` at
     B = 2, P = 12 and 8 `decode_step`s on the card against the same
     weights on the CPU (logits within atol = rtol = 1e-4; the card fed
     the CPU's greedy tokens and its own greedy tokens equal to them),
     decode from an empty cache == the full forward (atol 5e-3, rtol
     1e-2; MoE at capacity_factor 8), a repeat on the card bit-equal;
     (b) qwen3-0.6b at full width (28 layers, vocab 151,936, ~751 M
     params) the same way at P = 32 within 1e-3 (a step whose CPU top-2
     gap is under 1e-4 is printed as a tie, not failed); (c) those
     weights in the config's bfloat16: prefill B = 4 x P = 2048, 128
     decode steps at B = 4 and 64 ending at max_seq 2048, and
     `BatchedServer` serving three requests for 16 steps twice (same
     tokens), and `launch.serve.run` at its defaults (its own weights
     from the seed); tokens/s, p50/p99 ms a step and peak memory, beside
     its bound (decode: the weights plus the attended cache rows read
     once over 3.35 TB/s; prefill: the block products, causal attention
     and last-position head over 989 TFLOP/s bf16); (d) olmoe-1b-7b at
     full width cut to 2 layers: card == CPU as (b), expert ids equal in
     every router call, then bfloat16 timings as (c) at B = 4; (e) the
     mean of (c)'s bfloat16 `forward_hidden` over 2^14 sequences x 32
     tokens (ids drawn from [0, 64), labelled "token 7 before token 9" as
     `examples/rf_on_embeddings.py`) as float32 features of a 4-tree
     depth-10 `backend="kernel"` forest: split_scan must launch, a repeat
     must grow the same trees, split_scan is held bit-equal to its plain
     version on every level's inputs of one tree batch and timed at the
     deepest; the held-out AUC is printed.  `--lm` runs
     phases 0, 1 and 11 alone (with `--profile`: each timed prefill and
     8 more decode steps under the profiler).
 12. LM training (`repro_torch.train.step`, AdamW, `launch.train`), no
     kernel on its path (the three counters must stay 0): (a) every
     registered architecture's reduced variant (float32), one train step
     at lr 1e-3 on the card from the CPU's state and batch (B = 2, S =
     80): metrics within rtol 1e-4; every parameter's update p_new −
     p_old within the gap the two sides' moments allow
     (`lm_train_update_tolerance`: ~1e-6 of lr where they agree), so a
     missing, flipped or mis-scaled update fails; moments within 1e-4 of
     each leaf's scale; a repeat on the card bit-equal; a census of
     torch's deterministic-algorithm alerts; (b) the ~100M config of
     `examples/train_lm.py --hundred-m` (12 x 768, vocab 32,768,
     float32): one step card == CPU (B = 1, S = 32; moments within 1e-3
     of scale), then `launch.train.train_loop` 50 steps at B = 16 x S =
     512, lr 1e-3, whose mean ce over the last 10 steps must be below
     the first 10's; (e) train-state checkpoints ((b)'s state
     and a bfloat16 one) written and restored on the card bit for bit;
     (c) qwen3-0.6b at full width: one float32 step card == CPU as (b),
     then 10 bfloat16 steps at B = 4 x S = 2048, remat full; (f) two
     runs of 3 of those steps bit-equal; (d) olmoe-1b-7b at full width
     cut to 2 layers: one float32 step card == CPU with expert ids
     equal in every router call and a repeat bit-equal, then 4 bfloat16
     steps at B = 4 x S = 2048.  (b)-(d) print step p50/p99 ms,
     tokens/s, the bound (full remat: 8·(block and head params)·tokens +
     4x the causal attention products over the dtype's peak) and peak
     memory.  `--lm-train` runs phases 0, 1 and 12 alone (with
     `--profile`: one more step of (c) and (d) under the profiler);
 13. the rest of the reference's API, each fatal on failure: (a) the
     legacy closure API, `fit(ds, supersplit_fn=closure)`, at 2 trees and
     depth 10: a sorted closure calling the kernel scorer (split_scan,
     with cat_hist for the categorical columns) on phase 3's Leo rows and
     a hist closure (feat_hist, float thresholds) on phase 5's majority
     rows, each warned, built per tree with no batched step and equal to
     the engine fit's trees, the last captured call of each kernel held
     bit-equal to its plain version; (b) sharded LM training in 4 gloo
     ranks on this card, a (2, 2) ("data", "model") `DeviceMesh` (gloo's
     eager collectives asked first on CUDA tensors; DTensor's functional
     collectives routed to them): qwen3-0.6b float32, one sharded step
     == the one-device card step and a repeat bit-equal, shard by shard
     on each rank; then 5 bfloat16 steps (the first a warm-up) at B = 4
     x S = 2048, remat full (p50/p99 a rank,
     peak, collective bytes a step by axis; no scaling figure: the
     ranks share the card); olmoe-1b-7b at full width, 2 layers, two
     sharded bf16 steps; the reduced olmoe's sharded step on the card ==
     on CPU gloo ranks; no kernel may launch; (c) the dry run of (b)'s
     bf16 step on a fake (2, 2) world, whose FLOPs a rank must equal
     (b)'s real step's and FlopCounterMode's one-device step / 4, its
     peak printed beside (b)'s, then `launch.dryrun --arch qwen3-0.6b
     --both-meshes --drf` (predictions, labelled so).  `--lm-mesh` runs
     phases 0, 1 and 13 alone.
Every fit of phases 3, 5, 6 and 8 prints the sha256 of its packed trees
(`--forests --src DIR` prints those of phases 3, 5 and 6 for another
tree's port, on the same rows).  Prints phase 11's, 12's and the whole
run's seconds, a JSON line with every kernel's numbers (at GBT's shapes too,
and split_scan's launches in phase 11 (e)), the nvidia-smi
line, and last `{"ok": true, "device": {...}}`.  Exits non-zero without
a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32, outside the tensor cores
INT32_OP_PER_S = 16.7e12         # H100 SXM int32: 64 lanes, 132 SMs, 1.98 GHz
BAG_SHAPES = ((1 << 23, 1), (1 << 23, 2), (3 << 24, 1))  # (n, T) of the draw
TIMED_RUNS = 5
TREES, TREE_BATCH = 4, 2         # the phase-3 and phase-5 forests
TEST_ROWS = 1 << 20              # held-out rows for phases 4 and 5
DEEP_L1 = 16385                  # split_scan past a block's shared memory
HIST_BINS = 255                  # phase 5's bucket budget
PRUNE_MIN, PRUNE_FRAC = 32768, 0.05  # phase 6 (c): min_records, prune trigger
SEED_DEPTH = 8                   # phase 6 (e): the seed builder's depth
STREAM_CHUNKS = (1 << 20, 1 << 16)  # phase 7 (b): the two chunk sizes
STREAM_KILL_AFTER = 3            # phase 7 (d): level snapshots before SIGKILL
PEAK_SPREAD = 64 * 2**20         # phase 7 (c): most the two peaks may differ
GBT_SMALL_ROWS = 1 << 16         # phase 8 (e): rows of the card-vs-CPU cut
GBT_SMALL_ROUNDS = 5             # phase 8 (e): its rounds
SERVE_CALLS = 300                # phase 9 (c): single-row calls timed
DIST_WORLD = 4                   # phase 10: ranks, all on this card (gloo)
DIST_TIMEOUT = 900               # phase 10: seconds the ranks may take
SHARD_CHECK_CALL = 3             # phase 10: the wrapper call held to plain
EVAL_LEAVES = 511                # phase 10 (f): open leaves of the level
BF16_FLOP_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
LM_SMALL_P, LM_STEPS = 12, 8     # phase 11 (a): prompt length, decode steps
LM_FULL_P = 32                   # phase 11 (b), (d): prompt length
TIE_GAP = 1e-4                   # phase 11: a CPU top-2 gap under it is a tie
ROUTE_TIE = 1e-5                 # phase 11 (d): router probability tie
LM_PREFILL = (4, 2048)           # phase 11 (c), (d): timed prefill B, P
LM_DECODE_BATCHES = (4, 64)      # phase 11 (c): timed decode batches
LM_DECODE_STEPS, LM_MAX_SEQ = 128, 2048
LM_PREFILL_CHUNK = 8             # phase 11: sequences a cache-filling prefill
LM_SERVER_STEPS = 16             # phase 11 (c): BatchedServer steps
LM_PROFILE_STEPS = 8             # phase 11 with --profile: decode steps traced
LM_FEATURE_ROWS, LM_FEATURE_LEN = 1 << 14, 32   # phase 11 (e)
LM_FEATURE_VOCAB = 64            # phase 11 (e): token ids drawn from [0, 64)
LM_FEATURE_CHUNK = 1024          # phase 11 (e): sequences a forward
LM_TRAIN_SMALL = (2, 80)         # phase 12 (a), (e): B, S of the reduced steps
LM_TRAIN_CHECK = (1, 32)         # phase 12 (b)-(d): card == CPU step's B, S
LM_TRAIN_100M = (16, 512)        # phase 12 (b): train_lm.py --hundred-m
LM_TRAIN_100M_STEPS = 50         # phase 12 (b)
LM_TRAIN_FULL = (4, 2048)        # phase 12 (c), (d), (f): timed B, S
LM_TRAIN_FULL_STEPS = 10         # phase 12 (c): steps (the first a warm-up)
LM_TRAIN_MOE_STEPS = 4           # phase 12 (d): steps (the first a warm-up)
LM_TRAIN_REPEAT_STEPS = 3        # phase 12 (f): steps of each of two runs
LEGACY_TREES, LEGACY_DEPTH = 2, 10   # phase 13 (a): the closure forests
LM_MESH_WORLD = 4                # phase 13 (b): gloo ranks on this card
LM_MESH_SHAPE = (2, 2)           # phase 13 (b): ("data", "model")
LM_MESH_CHECK = (2, 32)          # phase 13 (b): the float32 check's B, S
LM_MESH_STEPS = 4                # phase 13 (b): bf16 steps after the warm-up
LM_MESH_MOE_SMALL = (4, 32)      # phase 13 (b): the reduced olmoe's B, S
LM_MESH_TIMEOUT = 900            # phase 13: seconds the workers may take
LM_MESH_DEVICE = "cuda"          # phase 13 (b): the ranks' device


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


def host_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Host milliseconds to enqueue one `fn()` (no synchronisation inside
    the timed calls): where it passes the card's time, the host bounds."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host = (time.perf_counter() - t0) / runs * 1e3
    torch.cuda.synchronize()
    return host


def sass_atomics(lib_path: Path) -> dict:
    """The atomic SASS instructions of each kernel in a built library, by
    op (`cuobjdump -sass`): ATOMS.* act on shared memory (ATOMS.ADD is a
    native integer add, ATOMS.CAST.SPIN a compare-and-swap loop), RED.* /
    ATOMG.* on device memory.  Empty where the toolkit has no cuobjdump."""
    import collections
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            continue
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED)\.[A-Z0-9_.]+)",
                             line):
            out.setdefault(fn, collections.Counter())[op] += 1
    return {k: dict(v) for k, v in out.items()}


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
    dt = torch.int32 if task == "classification" else torch.float32
    tot = torch.zeros((T * L1, S), dtype=dt, device=leaf.device)
    tot.index_add_(0, flat.reshape(-1), torch.where(
        inb[..., None], stats, 0.0).to(dt).reshape(T * n, S))
    return tot.reshape(T, L1, S)


def check_split_scan(args, dev, g, n, T, m, L1, impurity, task, C, timed,
                     plain_runs=3, layout=None):
    import torch
    from repro_torch.kernels import split_scan as ss
    S = C if task == "classification" else 3
    if layout is not None and ss.state_layout(L1, S) != layout:
        fail(f"split_scan L1={L1} S={S}: state layout "
             f"{ss.state_layout(L1, S)}, expected {layout}")
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
                                  runs=plain_runs)
        row["layout"] = ss.state_layout(L1, S)
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


def check_cat_hist(args, dev, g, n, T, m, L1, V, task, timed, inputs=None,
                   slot=None, m_prime=None):
    """cat_hist against its plain version, bit for bit (regression: both
    sum in the same 64-bit fixed point), and a regression table again
    (repeatable run to run).  With `slot` (a candidate mask's slot map):
    the compact tables, held at the candidates' slots against the plain
    version's; the bound counts the rows gathered for them."""
    import torch
    from repro_torch.kernels import cat_hist as ch
    S = 2 if task == "classification" else 3
    x, leaf, w, y = inputs or cat_inputs(g, n, T, m, L1, V, task, dev)
    kw = dict(L1=L1, V=V, num_stats=S, task=task)
    plain_kw = dict(kw)
    if slot is None:
        slot = ch.full_slots(T, m, L1, x.device)
    else:
        kw.update(slot=slot, m_prime=m_prime)
    n_tab = int((slot >= 0).sum().item())
    tk = ch.cat_hist(x, leaf, w, y, **kw).reshape(-1, V, S)[:n_tab]
    tp = ch.compact_tables(ch.cat_hist_plain(x, leaf, w, y, **plain_kw),
                           slot, n_tab)
    torch.cuda.synchronize()
    err = (tk - tp).abs().max().item()
    if not torch.equal(tk, tp):
        fail(f"cat_hist {task} V={V} L1={L1}: not bit-equal (max err {err})")
    if task == "regression" and not torch.equal(
            tk, ch.cat_hist(x, leaf, w, y, **kw).reshape(-1, V, S)[:n_tab]):
        fail(f"cat_hist regression V={V} L1={L1}: not deterministic")
    row = dict(n=n, T=T, m=m, L1=L1, V=V, task=task, tables=n_tab,
               max_abs_err=err, bit_equal=True)
    del tk, tp
    if timed:
        row["ms"] = cuda_ms(lambda: ch.cat_hist(x, leaf, w, y, **kw))
        row["plain_ms"] = cuda_ms(lambda: ch.cat_hist_plain(
            x, leaf, w, y, **plain_kw), runs=1)
        row["library_ms"] = cuda_ms(
            library_index_add(x, leaf, w, y, L1, V, S, task), runs=3)
        row["host_ms"] = host_ms(lambda: ch.cat_hist(x, leaf, w, y, **kw))
        row["kernels"] = kernel_split(lambda: ch.cat_hist(x, leaf, w, y,
                                                          **kw))
        gathered = ch.gathered_rows(leaf, w, slot, L1)
        row["gathered_rows"] = gathered
        row["bound_ms"], row["bound_by"] = bound_ms(
            ch.bound_bytes(T, m, n, L1, V, S, tables=n_tab,
                           gathered=gathered), gathered)
    torch.cuda.empty_cache()
    log(f"  cat_hist {json.dumps(row)}")
    return row


def check_breiman(args, dev, tables, cand, label, timed, impurity="gini",
                  min_records=1.0, plain_runs=1, slot=None):
    """breiman against its plain version on the card: gains bit for bit,
    masks equal wherever the gain is finite and all-False elsewhere, and
    the device counter up by the candidate segments.  Timed: the kernel,
    the plain version and the bound."""
    import torch
    from repro_torch.kernels import breiman
    kw = dict(impurity=impurity, min_records=min_records)
    scored0 = int(breiman.scored_counter(dev).item())
    gk, mk = breiman.breiman(tables, cand, slot, **kw)
    gp, mp = breiman.breiman_plain(tables, cand, slot, **kw)
    torch.cuda.synchronize()
    scored = int(breiman.scored_counter(dev).item()) - scored0
    n_cand = int(cand.sum().item())
    fin = torch.isfinite(gp)
    if not torch.equal(gk, gp):
        both = fin & torch.isfinite(gk)
        err = (gk[both] - gp[both]).abs().max().item() if both.any() else 0
        fail(f"breiman {label}: gains not bit-equal (finite masks equal: "
             f"{torch.equal(torch.isfinite(gk), fin)}, max err {err})")
    if not torch.equal(mk[fin], mp[fin]) or mk[~fin].any():
        fail(f"breiman {label}: masks differ where the gain is finite, or "
             f"a row without a valid cut has a flag")
    if scored != n_cand:
        fail(f"breiman {label}: {scored} segments scored, {n_cand} "
             f"candidates")
    T, m, L1 = cand.shape
    V, S = tables.shape[-2:]
    row = dict(T=T, m=m, L1=L1, V=V, S=S, impurity=impurity,
               min_records=min_records, candidates=n_cand,
               finite=int(fin.sum().item()), bit_equal=True)
    del gk, mk, gp, mp
    if timed:
        row["ms"] = cuda_ms(lambda: breiman.breiman(tables, cand, slot,
                                                    **kw))
        row["plain_ms"] = cuda_ms(
            lambda: breiman.breiman_plain(tables, cand, slot, **kw),
            runs=plain_runs)
        row["kernels"] = kernel_split(
            lambda: breiman.breiman(tables, cand, slot, **kw))
        row["bound_ms"], row["bound_by"] = bound_ms(
            breiman.bound_bytes(n_cand, T, m, L1, V, S), 0)
    torch.cuda.empty_cache()
    log(f"  breiman {label} {json.dumps(row)}")
    return row


def breiman_checks(args, dev):
    """breiman on cat_hist tables of random rows: small arities with every
    leaf a candidate, entropy, min_records 0 (the empty-tail cut) and
    large, and V = 10,000 with about 10 of 82 columns candidates; then on
    random tables of 5 and 20 classes and of 20,000 and 40,000
    categories."""
    import torch
    from repro_torch.kernels import cat_hist as ch
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 3)
    n = 1 << args.check_log2n
    for V, L1, share, impurity, min_records in (
            (2, 65, 1.0, "gini", 1.0), (40, 65, 1.0, "gini", 1.0),
            (40, 65, 1.0, "entropy", 1.0), (300, 65, 1.0, "gini", 0.0),
            (300, 65, 1.0, "gini", 200.0), (1000, 513, 1.0, "entropy", 1.0),
            (10000, 65, 10 / 82, "gini", 1.0)):
        ins = cat_inputs(g, n, 2, 8, L1, V, "classification", dev)
        tables = ch.cat_hist(*ins, L1=L1, V=V, num_stats=2)
        cand = torch.rand((2, 8, L1), generator=g, device=dev) < share
        cand[..., 0] = False
        check_breiman(args, dev, tables, cand, f"V={V} L1={L1}", False,
                      impurity, min_records)
        del tables, ins
    # integer class counts up to 4000: many classes (registers up to 16,
    # the workspace past it) and arities past one block's shared memory
    for V, S, impurity in ((300, 5, "gini"), (300, 20, "entropy"),
                           (20000, 2, "gini"), (40000, 2, "entropy"),
                           (40000, 20, "gini")):
        top = 4000 if V <= 300 else 3
        tables = torch.randint(0, top, (2, 4, 17, V, S), generator=g,
                               device=dev, dtype=torch.int32)
        tables *= torch.rand((2, 4, 17, V, 1), generator=g,
                             device=dev) < 0.5
        cand = torch.rand((2, 4, 17), generator=g, device=dev) < 0.7
        check_breiman(args, dev, tables, cand, f"V={V} S={S}", False,
                      impurity)
        del tables


def breiman_main_shapes(args, dev, ds):
    """breiman at the shapes of the deepest level of the main path: the Leo
    columns' tables (real arities padded to V = 10,000) over 2^23 rows in
    L1 = 513 leaves of 2 trees, about 10 of 82 columns candidates a leaf."""
    import torch
    from repro_torch.core import bagging
    from repro_torch.kernels import cat_hist as ch
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 2)
    T, L1, n = TREE_BATCH, 2 ** (args.depth - 1) + 1, ds.n
    leaf = torch.randint(0, L1, (T, n), generator=g, device=dev,
                         dtype=torch.int32)
    w = bagging.bag_counts_forest(args.seed, range(T), n, "poisson", dev)
    y = torch.as_tensor(ds.labels, device=dev).float()
    cat_cols = torch.as_tensor(ds.cat, device=dev).t().contiguous()
    V = max(ds.arities)
    tables = ch.cat_hist(cat_cols, leaf, w, y, L1=L1, V=V, num_stats=2)
    del cat_cols, leaf, w, y
    cand = torch.rand((T, ds.m_cat, L1), generator=g, device=dev) < 10 / 82
    cand[..., 0] = False
    r = check_breiman(args, dev, tables, cand, "main-path shapes", True)
    del tables
    torch.cuda.empty_cache()
    return dict(shape={k: r[k] for k in ("T", "m", "L1", "V", "S")},
                max_abs_err=0.0, library_ms=None,
                **{k: r[k] for k in ("candidates", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "kernels")})


def feat_inputs(g, n, T, m, W, B, bin_dtype, task, dev):
    """Bin ids of `bin_dtype`, slots in [0, W) (a third of them 0), bag
    weights in {0, 1, 2} and labels."""
    import torch
    x = torch.randint(0, B, (m, n), generator=g, device=dev,
                      dtype=torch.int32)
    x = (x.to(torch.uint8) if bin_dtype == torch.uint8
         else x.to(torch.int16).view(torch.uint16))
    slot = torch.randint(1, W, (T, n), generator=g, device=dev,
                         dtype=torch.int32) if W > 1 else torch.zeros(
        (T, n), dtype=torch.int32, device=dev)
    slot = torch.where(torch.rand((T, n), generator=g, device=dev) < 1 / 3,
                       0, slot).to(torch.int32)
    w = torch.randint(0, 3, (T, n), generator=g, device=dev).float()
    if task == "classification":
        y = torch.randint(0, 2, (n,), generator=g, device=dev).float()
    else:
        y = torch.randn((n,), generator=g, device=dev) * 3 + 1
    return x, slot, w, y


def library_feat_index_add(x, slot, w, y, W, B, S, task):
    """One PyTorch call computing the same tables: `index_add_` on flat
    (tree, column, slot, bin) ids.  Ids and row stats are prepared outside
    the timed call."""
    import torch
    from repro_torch.core import presort, splits
    T, n = slot.shape
    m = x.shape[0]
    stats = splits.row_stats(y, w, S, task)
    inb = (w > 0) & (slot > 0)
    contrib = torch.where(inb[..., None], stats, 0.0)           # (T, n, S)
    contrib = contrib[:, None].expand(T, m, n, S).reshape(-1, S)
    base = torch.arange(T * m, device=x.device).reshape(T, m, 1)
    flat = ((base * W + slot.long()[:, None]) * B
            + presort.bin_ids(x).long()[None]).reshape(-1)

    def call():
        out = torch.zeros((T * m * W * B, S), device=x.device)
        out.index_add_(0, flat, contrib)
        return out
    return call


def check_feat_hist(args, dev, g, n, T, m, W, B, bin_dtype, task, timed,
                    inputs=None):
    """feat_hist against its plain version, as `check_cat_hist`."""
    import torch
    from repro_torch.kernels import feat_hist as fh
    S = 2 if task == "classification" else 3
    x, slot, w, y = inputs or feat_inputs(g, n, T, m, W, B, bin_dtype, task,
                                          dev)
    kw = dict(W=W, B=B, num_stats=S, task=task)
    tk = fh.feat_hist(x, slot, w, y, **kw)
    tp = fh.feat_hist_plain(x, slot, w, y, **kw)
    torch.cuda.synchronize()
    err = (tk - tp).abs().max().item()
    name = f"feat_hist {str(x.dtype)[6:]} B={B} W={W} {task}"
    if float(tk[:, :, 0].abs().sum()) != 0.0:
        fail(f"{name}: slot 0 is not discarded")
    if not torch.equal(tk, tp):
        fail(f"{name}: not bit-equal (max err {err})")
    if task == "regression" and not torch.equal(
            tk, fh.feat_hist(x, slot, w, y, **kw)):
        fail(f"{name}: not deterministic")
    row = dict(n=n, T=T, m=m, W=W, B=B, bins=str(x.dtype)[6:], task=task,
               max_abs_err=err, bit_equal=True)
    if task == "regression":
        row["sha256"] = hashlib.sha256(tk.cpu().numpy().tobytes()).hexdigest()
    del tk, tp
    if timed:
        row["ms"] = cuda_ms(lambda: fh.feat_hist(x, slot, w, y, **kw))
        row["plain_ms"] = cuda_ms(lambda: fh.feat_hist_plain(x, slot, w, y,
                                                             **kw), runs=1)
        row["library_ms"] = cuda_ms(
            library_feat_index_add(x, slot, w, y, W, B, S, task), runs=3)
        adds = ((slot > 0) & (w > 0)).sum().item() * m
        row["bound_ms"], row["bound_by"] = bound_ms(
            fh.bound_bytes(T, m, n, W, B, S, x.element_size()), adds)
    torch.cuda.empty_cache()
    log(f"  {json.dumps(row)}")
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
    breiman_checks(args, dev)
    import torch
    for bin_dtype, B in ((torch.uint8, 255), (torch.uint16, 1024)):
        for W in (2, 65, 257):
            for task in ("classification", "regression"):
                check_feat_hist(args, dev, g, n, 2, 8, W, B, bin_dtype, task,
                                False)
    # past a block's shared memory the per-leaf state lives in device
    # memory: phase 3's from L1 = 16,385 leaves, phase 1's as well from
    # L1 = 32,769; bit-equal to the plain version all the same
    for L1, sums in ((DEEP_L1, "shared"), (2 * DEEP_L1 - 1, "global")):
        check_split_scan(args, dev, g, (1 << 18) - 37, 2, 3, L1, "gini",
                         "classification", 2, True, plain_runs=1,
                         layout={"sums": sums, "best": "global"})


def deep_fit(args, dev):
    """An exact fit deep enough that split_scan keeps its per-leaf state
    in device memory: TreeParams(max_depth=16, backend="kernel") on 2^18
    rows of the "majority" family over 16 informative numeric columns,
    with 30% of the labels flipped.  (With 6 informative columns the noise
    splits turn lopsided past depth 8 and the frontier stays under 4096.)
    It must reach a padded frontier of at least 8192, and a repeat must
    grow the same trees."""
    import numpy as np
    import torch
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.dataset import from_numpy
    from repro_torch.core.forest import RandomForest
    from repro_torch.data import synthetic
    ds = synthetic.make_tabular("majority", 1 << 18, num_informative=16,
                                num_useless=0, seed=args.seed)
    flip = np.random.default_rng(args.seed + 1).random(ds.n) < 0.3
    ds = from_numpy(ds.num, None, (ds.labels ^ flip).astype(np.int32))
    params = tree_lib.TreeParams(max_depth=16, backend="kernel")

    def fit():
        return RandomForest(params, num_trees=2, seed=args.seed,
                            tree_batch=2).fit(ds, collect_stats=True)

    t0 = time.perf_counter()
    rf = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    lp_max = max(tree_lib._pad_leaves(s.open_leaves, params.leaf_pad)
                 for log_t in rf.level_stats for s in log_t)
    again = fit()
    log(f"  deep fit: depth <= 16 on n={ds.n} numeric rows with 30% label "
        f"noise, {fit_s:.3f} s; largest padded frontier Lp = {lp_max}; "
        f"nodes per tree {[t.num_nodes for t in rf.trees]}")
    if lp_max < 8192:
        fail(f"the deep fit reached Lp = {lp_max}, not 8192")
    if not same_trees(rf.trees, again.trees):
        fail("a repeat of the deep fit grew different trees")
    log("  repeat deep fit grew identical trees")
    return dict(fit_s=fit_s, lp_max=lp_max)


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


def majority_dataset(seed: int, n: int):
    """The paper's artificial "majority" family as the reference's hist
    benchmark draws it: 6 informative + 10 useless float32 numeric
    columns, label = whether most informative columns are positive."""
    from repro_torch.data import synthetic
    return synthetic.make_tabular("majority", n, num_informative=6,
                                  num_useless=10, seed=seed)


def hist_params(args):
    from repro_torch.core import tree as tree_lib
    return tree_lib.TreeParams(max_depth=args.depth, backend="kernel",
                               split_mode="hist", num_bins=HIST_BINS)


def capture_feat_hist_levels(args, ds):
    """The arguments of every `feat_hist` call of one tree batch of fit
    (b), level by level: the fit runs through `RandomForest.fit` with a
    recorder around the port's `ops.feature_tables` adapter, which keeps
    each level's inputs as the kernel's wrapper receives them."""
    import torch
    from repro_torch.core.forest import RandomForest
    from repro_torch.kernels import ops as kops
    levels = []
    adapter = kops.feature_tables

    def record(bin_of, slots, w, labels, *, B, W, task, num_classes):
        levels.append(dict(
            x=bin_of.contiguous(), slot=slots.to(torch.int32).clone(),
            w=w.contiguous(), y=labels.to(torch.float32).contiguous(), W=W,
            B=B, task=task, S=kops.stat_dim(num_classes, task)))
        return adapter(bin_of, slots, w, labels, B=B, W=W, task=task,
                       num_classes=num_classes)

    kops.feature_tables = record
    try:
        RandomForest(hist_params(args), num_trees=TREE_BATCH, seed=args.seed,
                     tree_batch=TREE_BATCH).fit(ds)
    finally:
        kops.feature_tables = adapter
    return levels


def exact_params(args):
    from repro_torch.core import tree as tree_lib
    return tree_lib.TreeParams(max_depth=args.depth, backend="kernel")


def capture_exact_levels(args, ds):
    """The arguments of every `split_scan`, `cat_hist` and `breiman` call of
    one tree batch of the exact Leo fit (phase 3), level by level: the fit
    runs through `RandomForest.fit` with recorders around the port's
    `ops.split_scan_supersplit`, `ops.categorical_tables` and
    `ops.breiman_splits` adapters, which keep each level's inputs as the
    kernels' wrappers receive them (the presorted and categorical columns,
    labels and bag weights are the same tensors at every level and are kept
    once; breiman's tables are not kept, being cat_hist's output)."""
    import torch
    from repro_torch.core.forest import RandomForest
    from repro_torch.kernels import ops as kops
    levels = []
    ss_adapter = kops.split_scan_supersplit
    cat_adapter = kops.categorical_tables
    brm_adapter = kops.breiman_splits

    def own(t):                 # a contiguous copy the fit cannot change
        return t.clone(memory_format=torch.contiguous_format)

    def record_ss(sorted_vals, sorted_idx, leaf_of, w, labels, cand, totals,
                  impurity="gini", task="classification", min_records=1.0):
        levels.append(dict(ss=dict(
            ins=(sorted_vals.contiguous(), sorted_idx.contiguous(),
                 own(leaf_of), w.contiguous(),
                 labels.to(torch.float32).contiguous(), own(cand),
                 own(totals)),
            kw=dict(impurity=impurity, task=task, min_records=min_records))))
        return ss_adapter(sorted_vals, sorted_idx, leaf_of, w, labels, cand,
                          totals, impurity, task, min_records)

    def record_cat(cat_cols, leaf_of, w, labels, *, V, Lp, task,
                   num_classes, slot=None, m_prime=None):
        ss = levels[-1]["ss"]["ins"]
        levels[-1]["cat"] = dict(
            ins=(cat_cols.contiguous(), ss[2], ss[3], ss[4]),
            kw=dict(L1=Lp + 1, V=V,
                    num_stats=kops.stat_dim(num_classes, task), task=task,
                    slot=None if slot is None else own(slot),
                    m_prime=m_prime))
        if not torch.equal(leaf_of, ss[2]):
            fail("capture: the categorical engine saw other leaf ids than "
                 "the numeric engine of the same level")
        return cat_adapter(cat_cols, leaf_of, w, labels, V=V, Lp=Lp,
                           task=task, num_classes=num_classes, slot=slot,
                           m_prime=m_prime)

    def record_brm(tables, cand, impurity="gini", min_records=1.0,
                   slot=None):
        levels[-1]["brm"] = dict(cand=own(cand), kw=dict(
            impurity=impurity, min_records=min_records))
        return brm_adapter(tables, cand, impurity, min_records, slot=slot)

    kops.split_scan_supersplit = record_ss
    kops.categorical_tables = record_cat
    kops.breiman_splits = record_brm
    try:
        RandomForest(exact_params(args), num_trees=TREE_BATCH,
                     seed=args.seed, tree_batch=TREE_BATCH).fit(ds)
    finally:
        kops.split_scan_supersplit = ss_adapter
        kops.categorical_tables = cat_adapter
        kops.breiman_splits = brm_adapter
    return levels


def breiman_levels(args, dev, levels):
    """breiman on every captured level of one tree batch of the exact Leo
    fit (its tables rebuilt by cat_hist from the level's inputs): held
    against its plain version and timed, with the plain version's time.
    Returns the per-level rows and the sums."""
    import torch
    from repro_torch.kernels import cat_hist as ch
    rows = []
    for depth, lv in enumerate(levels):
        tables = ch.cat_hist(*lv["cat"]["ins"], **lv["cat"]["kw"])
        r = check_breiman(args, dev, tables, lv["brm"]["cand"],
                          f"exact fit level {depth}", True,
                          slot=lv["cat"]["kw"]["slot"], **lv["brm"]["kw"])
        del tables
        torch.cuda.empty_cache()
        rows.append(dict(depth=depth, **{k: r[k] for k in (
            "L1", "candidates", "finite", "ms", "plain_ms", "bound_ms")}))
    out = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms",
                                                "bound_ms")}
    log(f"  breiman over the {len(rows)} levels of one tree batch of the "
        f"exact fit (bit-equal at each): {out['ms']:.3f} ms, plain "
        f"{out['plain_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms")
    return dict(levels=rows, **out)


def kernel_split(fn, runs: int = 3) -> dict:
    """Device milliseconds per call of each kernel that `fn()` launches,
    by name (torch.profiler, `runs` calls after a warm-up)."""
    import collections
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            name = re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "",
                          e.name)[:40]
            out[name] += (e.time_range.end - e.time_range.start) / 1e3 / runs
    return {k: round(v, 4) for k, v in out.items()}


def exact_main_levels(args, dev, ds):
    """split_scan and cat_hist on the inputs that every level of one tree
    batch of the exact Leo fit gives them (`capture_exact_levels`): at each
    level both are held against their plain versions (bit-equal: binary
    gini, classification counts; cat_hist's tables at the slots of the
    level's candidates) and timed, cat_hist also on the columns of arity
    <= 64 and > 64 alone and with no candidate (every block returns), and
    the device time of each kernel the two launch is split by name
    (`kernel_split`).  Returns the per-level and summed times."""
    import torch
    from repro_torch.kernels import cat_hist as ch
    from repro_torch.kernels import split_scan as ss
    levels = capture_exact_levels(args, ds)
    low = [j for j, a in enumerate(ds.arities) if a <= 64]
    high = [j for j, a in enumerate(ds.arities) if a > 64]
    x = levels[0]["cat"]["ins"][0]
    x_low, x_high = x[low].contiguous(), x[high].contiguous()
    rows = []
    for depth, lv in enumerate(levels):
        s_ins, s_kw = lv["ss"]["ins"], lv["ss"]["kw"]
        c_ins, c_kw = lv["cat"]["ins"], lv["cat"]["kw"]
        slot = c_kw["slot"]
        plain_kw = {k: v for k, v in c_kw.items()
                    if k not in ("slot", "m_prime")}

        def part(cols):         # c_kw over the columns `cols` only
            return dict(c_kw, slot=ch.candidate_slots(slot[:, cols] >= 0))
        gk, tk = ss.split_scan(*s_ins, **s_kw)
        gp, tp = ss.split_scan_plain(*s_ins, **s_kw)
        if not (torch.equal(gk, gp) and torch.equal(tk, tp)):
            fail(f"split_scan on level {depth} of the exact fit: not "
                 f"bit-equal")
        del gk, tk, gp, tp
        n_tab = int((slot >= 0).sum().item())
        ck = ch.cat_hist(*c_ins, **c_kw)[:n_tab]
        cp = ch.compact_tables(ch.cat_hist_plain(*c_ins, **plain_kw), slot,
                               n_tab)
        if not torch.equal(ck, cp):
            fail(f"cat_hist on level {depth} of the exact fit: not "
                 f"bit-equal")
        del ck, cp
        torch.cuda.empty_cache()
        leaf, w = s_ins[2], s_ins[3]
        r = dict(depth=depth, L1=c_kw["L1"], tables=n_tab,
                 open_leaves=sum(int(torch.unique(lt[(lt > 0) & (wt > 0)])
                                     .numel()) for lt, wt in zip(leaf, w)),
                 split_scan_ms=cuda_ms(lambda: ss.split_scan(*s_ins,
                                                             **s_kw)),
                 cat_hist_ms=cuda_ms(lambda: ch.cat_hist(*c_ins, **c_kw)),
                 cat_hist_arity_le_64_ms=cuda_ms(
                     lambda: ch.cat_hist(x_low, *c_ins[1:], **part(low))),
                 cat_hist_arity_gt_64_ms=cuda_ms(
                     lambda: ch.cat_hist(x_high, *c_ins[1:], **part(high))),
                 split_scan_kernels=kernel_split(
                     lambda: ss.split_scan(*s_ins, **s_kw)),
                 cat_hist_kernels=kernel_split(
                     lambda: ch.cat_hist(*c_ins, **c_kw)),
                 # every block returns at once: their cost
                 cat_hist_no_cand_kernels=kernel_split(
                     lambda: ch.cat_hist(*c_ins, **dict(
                         c_kw, slot=torch.full_like(slot, -1)))))
        torch.cuda.empty_cache()
        log(f"  exact fit level {json.dumps(r)}")
        rows.append(r)
    out = {k: sum(r[k] for r in rows) for k in ("split_scan_ms",
                                                "cat_hist_ms")}
    brm = breiman_levels(args, dev, levels)
    out["breiman_ms"], out["breiman_plain_ms"] = brm["ms"], brm["plain_ms"]
    log(f"  over the {len(rows)} levels of one tree batch of the exact fit "
        f"(bit-equal at each): split_scan {out['split_scan_ms']:.3f} ms, "
        f"cat_hist {out['cat_hist_ms']:.3f} ms; deepest level "
        f"{rows[-1]['split_scan_ms']:.3f} / {rows[-1]['cat_hist_ms']:.3f} ms")
    del levels
    torch.cuda.empty_cache()
    return dict(levels=rows, **out)


def regression_target(ds):
    """A regression target on the majority rows, for holding feat_hist's
    fixed-point tables at the fit's real shapes: 3·x0 + x1 (float32)."""
    import numpy as np
    return (3 * ds.num[:, 0] + ds.num[:, 1]).astype(np.float32)


def feat_hist_main_shapes(args, dev, ds, label="(b)"):
    """feat_hist at the shapes and on the data that fit (b) gives it (or
    another hist fit of `ds`, named `label`):
    each level's real bin cache (uint8, B = 255), bag weights and scatter
    slots (raw leaf ids at the root, packed build slots under subtraction
    below it), captured from one tree batch of that fit.  At every level
    the kernel is held bit-equal to its plain version and timed beside
    its bound; the same level's regression table (target
    `regression_target`) must repeat bit for bit and agree with the plain
    version, and its sha256 is kept (two trees' kernels give the same
    hash when their tables are bit-equal).  At the root and at the
    deepest level the plain version and the library call are timed too;
    the deepest level's numbers go into the kernels line."""
    import torch
    from repro_torch.kernels import feat_hist as fh
    levels = capture_feat_hist_levels(args, ds)
    y_reg = torch.as_tensor(regression_target(ds), device=dev)
    rows = []
    for depth, lv in enumerate(levels):
        ins = (lv["x"], lv["slot"], lv["w"], lv["y"])
        T, n = lv["slot"].shape
        m = lv["x"].shape[0]
        kw = dict(W=lv["W"], B=lv["B"], num_stats=lv["S"], task=lv["task"])
        edge = depth in (0, len(levels) - 1)
        r = check_feat_hist(args, dev, None, n, T, m, lv["W"], lv["B"],
                            lv["x"].dtype, lv["task"], edge, inputs=ins)
        if not edge:
            r["ms"] = cuda_ms(lambda: fh.feat_hist(*ins, **kw))
            adds = ((lv["slot"] > 0) & (lv["w"] > 0)).sum().item() * m
            r["bound_ms"], r["bound_by"] = bound_ms(
                fh.bound_bytes(T, m, n, lv["W"], lv["B"], lv["S"],
                               lv["x"].element_size()), adds)
        reg_ins = ins[:3] + (y_reg,)
        reg = check_feat_hist(args, dev, None, n, T, m, lv["W"], lv["B"],
                              lv["x"].dtype, "regression", False,
                              inputs=reg_ins)
        r.update(depth=depth, W=lv["W"], rows_in_slots=int(
            ((lv["slot"] > 0) & (lv["w"] > 0)).sum().item()),
            host_ms=host_ms(lambda: fh.feat_hist(*ins, **kw)),
            kernels=kernel_split(lambda: fh.feat_hist(*ins, **kw)),
            regression_ms=cuda_ms(lambda: fh.feat_hist(
                *reg_ins, **dict(kw, num_stats=3, task="regression"))),
            regression_sha256=reg["sha256"])
        log(f"  feat_hist fit {label} level {json.dumps(r)}")
        rows.append(r)
    deepest = rows[-1]
    total = sum(r["ms"] for r in rows)
    log(f"  feat_hist over the {len(rows)} levels of one tree batch of fit "
        f"{label}, bit-equal to plain at each: {total:.3f} ms (bound "
        f"{sum(r['bound_ms'] for r in rows):.3f} ms; root "
        f"{rows[0]['ms']:.3f} ms, deepest {deepest['ms']:.3f} ms)")
    del levels
    torch.cuda.empty_cache()
    return dict(shape=dict(n=ds.n, T=TREE_BATCH, m=ds.m_num, W=deepest["W"],
                           B=HIST_BINS, S=2, bins="uint8",
                           depth=deepest["depth"]),
                root=dict(W=rows[0]["W"], ms=rows[0]["ms"],
                          plain_ms=rows[0]["plain_ms"],
                          library_ms=rows[0]["library_ms"],
                          bound_ms=rows[0]["bound_ms"]),
                levels_ms=total,
                levels=[{k: r[k] for k in ("depth", "W", "rows_in_slots",
                                           "ms", "host_ms", "kernels",
                                           "bound_ms", "regression_ms",
                                           "regression_sha256")}
                        for r in rows],
                **{k: deepest[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")})


def parent_feat_hist_levels(args, parent: Path) -> dict:
    """The parent tree's feat_hist on the same levels: this script run in
    a subprocess against `parent`/src with --hist-levels, its per-level
    rows (by fit) read back from a JSON file."""
    out = ROOT / "build" / "repro_torch" / "parent_hist_levels.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--hist-levels",
           "--src", str(parent / "src"), "--levels-json", str(out),
           "--seed", str(args.seed), "--train-log2n", str(args.train_log2n),
           "--depth", str(args.depth)]
    log(f"  the parent's feat_hist ({parent / 'src'}), in a subprocess")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if "level" in line or "built" in line:
            log(f"  [parent] {line.strip()}")
    if proc.returncode != 0:
        fail(f"the parent's per-level run failed:\n{proc.stderr[-4000:]}")
    return json.loads(out.read_text())


def compare_hist_levels(new: list, old: list, label: str) -> None:
    """Per-level times of this tree's feat_hist beside the parent's, and
    their regression tables' hashes, which must be equal."""
    log(f"  fit {label}, this tree beside the parent:")
    log("  depth  W  rows_in_slots  ms  parent_ms  bound_ms  regression_ms "
        " parent_regression_ms  regression bit-equal")
    for a, b in zip(new, old):
        same = a["regression_sha256"] == b["regression_sha256"]
        log(f"  {a['depth']} {a['W']} {a['rows_in_slots']} {a['ms']:.4f} "
            f"{b['ms']:.4f} {a['bound_ms']:.4f} {a['regression_ms']:.4f} "
            f"{b.get('regression_ms', float('nan')):.4f} {same}")
        if not same:
            fail(f"feat_hist regression tables of fit {label} at depth "
                 f"{a['depth']} differ from the parent kernel's")
    log(f"  sum {sum(a['ms'] for a in new):.3f} ms, parent "
        f"{sum(b['ms'] for b in old):.3f} ms")


def bag_main_shapes(args, dev) -> dict:
    """The Poisson bag kernel at the main path's shapes (BAG_SHAPES: 2^23
    rows at T = 1 and 2, one card's Leo share of 3·2^24 at T = 1), each
    draw bit-equal to the plain loop on the card, one launch a call, timed
    beside the plain loop and the bound; and the kernel's log equal to
    torch.log over all 2^23 uniforms a draw can give."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import bagging as bk
    k = torch.arange(bk.UNIFORMS, dtype=torch.int32, device=dev)
    u = (k | 0x3F800000).view(torch.float32) - 1.0       # bits k << 9
    diff = int((bk.uniform_log(dev).view(torch.int32)
                != torch.log(u).view(torch.int32)).sum().item())
    del k, u
    if diff:
        fail(f"bagging: the kernel's log differs from torch.log at {diff} "
             f"of {bk.UNIFORMS} uniforms")
    log(f"  bagging log == torch.log over all {bk.UNIFORMS} uniforms")
    key = prng.prng_key(args.seed)
    out = {}
    for n, T in BAG_SHAPES:
        trees = range(7, 7 + T)
        launches = bk.launches
        got = bk.poisson(key, trees, n, dev)
        torch.cuda.synchronize()
        if bk.launches != launches + 1:
            fail(f"bagging n={n} T={T}: {bk.launches - launches} launches")
        want = bk.poisson_plain(key, trees, n, dev)
        if not torch.equal(got, want):
            bad = int((got != want).sum().item())
            fail(f"bagging n={n} T={T}: {bad} counts differ from the plain "
                 f"loop's")
        passes = T * n + int(got.sum(dtype=torch.float64).item())
        top = int(got.max().item())
        del got, want
        t_bytes = bk.bound_bytes(T, n) / HBM_BYTES_PER_S * 1e3
        t_ops = bk.bound_int_ops(passes) / INT32_OP_PER_S * 1e3
        row = dict(n=n, T=T, passes=passes, max_count=top,
                   ms=cuda_ms(lambda: bk.poisson(key, trees, n, dev)),
                   plain_ms=cuda_ms(lambda: bk.poisson_plain(key, trees, n,
                                                             dev), runs=1),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        row["host_ms"] = host_ms(lambda: bk.poisson(key, trees, n, dev))
        log(f"  bagging main-path shape, bit-equal {json.dumps(row)}")
        out[f"{n}x{T}"] = row
        torch.cuda.empty_cache()
    return out


def phase2_main_shapes(args, dev, ds):
    """Both kernels at the shapes the deepest level of the main path gives
    them: the training columns, L1 = 513 leaves, V = 10,000 (cat_hist's
    tables for the candidates of the level plan's draw)."""
    import torch
    from repro_torch.core import bagging, presort
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import cat_hist as ch
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
    # the level plan's draw: m' of the m_num + m_cat columns a leaf, the
    # categorical ones kept (leaf 0 is closed)
    m_prime = tree_lib._num_candidates(tree_lib.TreeParams(),
                                       ds.m_num + ds.m_cat)
    keys = torch.rand((T, L1, ds.m_num + ds.m_cat), generator=g, device=dev)
    drawn = torch.zeros_like(keys, dtype=torch.bool).scatter_(
        2, keys.topk(m_prime, 2).indices, True)
    drawn[:, 0] = False
    cand = drawn[..., ds.m_num:].transpose(1, 2).contiguous()
    r = check_cat_hist(args, dev, g, n, T, ds.m_cat, L1, V,
                       "classification", True,
                       inputs=(cat_cols, leaf, w, y),
                       slot=ch.candidate_slots(cand), m_prime=m_prime)
    rows["cat_hist"] = dict(shape=dict(n=n, T=T, m=ds.m_cat, L1=L1, V=V,
                                       S=2),
                            **{k: r[k] for k in ("max_abs_err", "tables",
                                                 "gathered_rows", "ms",
                                                 "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")})
    del cat_cols, leaf, w, y
    torch.cuda.empty_cache()
    rows["breiman"] = breiman_main_shapes(args, dev, ds)
    rows["bagging"] = bag_main_shapes(args, dev)
    return rows


# ---------------------------------------------------------------------------
# Phases 3-4: training and prediction through the port's entry points
# ---------------------------------------------------------------------------

def tree_digest(trees) -> str:
    """sha256 of a forest's packed tree arrays (`pack_trees` on the CPU):
    two fits with equal digests grew bit-equal trees."""
    import numpy as np
    from repro_torch.core.forest import pack_trees
    pk = pack_trees(trees, device="cpu")
    h = hashlib.sha256(f"{pk.m_num} {pk.iters}".encode())
    for name, a in pk.to_arrays().items():
        h.update(name.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def same_trees(a, b) -> bool:
    import numpy as np
    keys = ("feature", "threshold", "is_cat", "cat_mask", "children",
            "value", "depth", "n_node")
    return len(a) == len(b) and all(
        np.array_equal(getattr(x, k), getattr(y, k))
        for x, y in zip(a, b) for k in keys)


def batch_levels(rf, tree_batch, leaf_pad):
    """Per tree batch and level: (depth, Lp, open leaves, rows, seconds,
    table bytes) from the fit's LevelStats.  Lp is the batch's padded
    frontier (the widest tree's), rows the rows the level scanned (fewer
    after a prune)."""
    from repro_torch.core import tree as tree_lib
    out = []
    for t0 in range(0, len(rf.trees), tree_batch):
        logs = rf.level_stats[t0:t0 + tree_batch]
        for s in logs[0]:
            peers = [x for log in logs for x in log if x.depth == s.depth]
            out.append(dict(
                depth=s.depth, open=s.open_leaves,
                Lp=tree_lib._pad_leaves(max(x.open_leaves for x in peers),
                                        leaf_pad),
                rows=s.rows_scanned // max(s.feature_passes, 1),
                s=s.wall_seconds, table_bytes=s.hist_table_bytes))
    return out


def run_fit(args, ds, params, kernels, label, idle=None, num_trees=TREES):
    """Fit `num_trees` trees through `RandomForest.fit` with the launch
    counters of `kernels` and `idle` (name -> module) set to 0 just before
    and read just after: every kernel of `kernels` must have launched, no
    kernel of `idle`.  Peak device memory must stay under 60 GiB, and a
    repeat fit must grow identical trees; with --profile a third fit runs
    under the profiler, its idle share taken against the repeat's wall."""
    import torch
    from repro_torch.core.forest import RandomForest
    idle = idle or {}

    def fit():
        return RandomForest(params, num_trees=num_trees, seed=args.seed,
                            tree_batch=TREE_BATCH).fit(ds, collect_stats=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (*kernels.values(), *idle.values()):
        mod.launches = 0
    t0 = time.perf_counter()
    rf = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in kernels.items()}
    idle_launches = {name: mod.launches for name, mod in idle.items()}
    levels = batch_levels(rf, TREE_BATCH, params.leaf_pad)
    peak = torch.cuda.max_memory_allocated()
    log(f"  {label} fit: {fit_s:.3f} s for {num_trees} trees of depth <= "
        f"{params.max_depth} on n={ds.n} rows x {ds.m} columns "
        f"(tree_batch={TREE_BATCH})")
    for lv in levels:
        extra = (f", table bytes {lv['table_bytes']}" if lv["table_bytes"]
                 else "")
        log(f"    level depth={lv['depth']} Lp={lv['Lp']} "
            f"open={lv['open']} rows={lv['rows']}: "
            f"{lv['s'] * 1e3:.3f} ms{extra}")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    log(f"  launches: {json.dumps(launches)}"
        + (f"; not on this path: {json.dumps(idle_launches)}" if idle
           else ""))
    digest = tree_digest(rf.trees)
    log(f"  nodes per tree: {[t.num_nodes for t in rf.trees]}; trees sha256 "
        f"{digest}")
    if launches and min(launches.values()) <= 0:
        fail(f"{label}: a kernel of the path never launched: {launches}")
    if any(idle_launches.values()):
        fail(f"{label}: launched a kernel off its path: {idle_launches}")
    if peak > 60 * 2**30:
        fail(f"{label}: peak device memory {peak / 2**30:.1f} GiB passes "
             f"60 GiB")
    t0 = time.perf_counter()
    again = fit()
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    log(f"  repeat {label} fit: {repeat_s:.3f} s")
    if not same_trees(rf.trees, again.trees):
        fail(f"a repeat {label} fit grew different trees")
    log(f"  repeat {label} fit grew identical trees")
    if args.profile:                # a third fit, against the repeat's wall
        del again
        profiled(fit, repeat_s)
    return rf, dict(fit_s=fit_s, repeat_s=repeat_s, levels=levels,
                    peak_bytes=peak, launches=launches, sha256=digest)


def phase3(args, dev, ds):
    """The exact Leo fit (and its repeat): split_scan, cat_hist and breiman
    must launch; the share of (tree, column, leaf) segments breiman scored
    (candidates) of those it was launched over is logged."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import bagging, breiman, cat_hist, split_scan
    params = tree_lib.TreeParams(max_depth=args.depth, backend="kernel")
    scored0 = int(breiman.scored_counter(dev).item())
    segments0 = breiman.segments
    out = run_fit(args, ds, params, {"split_scan": split_scan,
                                     "cat_hist": cat_hist,
                                     "breiman": breiman,
                                     "bagging": bagging}, "exact")
    scored = int(breiman.scored_counter(dev).item()) - scored0
    segments = breiman.segments - segments0
    out[1]["breiman_engagement"] = dict(scored=scored, segments=segments,
                                        share=scored / max(segments, 1))
    log(f"  breiman over the exact fit and its repeat: {scored} candidate "
        f"segments scored of {segments} launched over "
        f"({100 * scored / max(segments, 1):.2f}%)")
    root = [lv[0].max_class_weight for lv in out[0].level_stats]
    out[1]["root_max_class_weight"] = root
    log(f"  largest class weight at the root (LevelStats.max_class_weight), "
        f"per tree: {root}, {max(root) / 2**24:.4f} x 2^24 (int32 counts "
        f"are exact to 2^31)")
    return out


def phase5(args, dev, leo_train, leo_test, maj_train, maj_test):
    """Hist mode on the card, with subtraction: (a) the Leo-shaped rows,
    (b) the majority family.  An exact fit of the majority rows, once,
    is the point of comparison for (b) and for phase 6 (b)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan
    params = hist_params(args)
    rf_a, info_a = run_fit(args, leo_train, params,
                           {"feat_hist": feat_hist, "cat_hist": cat_hist,
                            "breiman": breiman}, "hist (a) Leo")
    info_a["auc"] = rf_a.auc(leo_test)
    log(f"  hist (a) held-out AUC {info_a['auc']:.6f}")
    if not info_a["auc"] > 0.6:
        fail(f"hist (a) AUC {info_a['auc']} is no better than chance")
    del rf_a
    rf_b, info_b = run_fit(args, maj_train, params, {"feat_hist": feat_hist},
                           "hist (b) majority")
    info_b["auc"] = rf_b.auc(maj_test)
    log(f"  hist (b) held-out AUC {info_b['auc']:.6f}")
    if not info_b["auc"] > 0.6:
        fail(f"hist (b) AUC {info_b['auc']} is no better than chance")
    info_b["trees"] = rf_b.trees        # phase 7's point of comparison
    del rf_b
    import torch
    from repro_torch.core.forest import RandomForest
    exact = tree_lib.TreeParams(max_depth=args.depth, backend="kernel")
    split_scan.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rf_e = RandomForest(exact, num_trees=TREES, seed=args.seed,
                        tree_batch=TREE_BATCH).fit(maj_train)
    torch.cuda.synchronize()
    info_e = dict(fit_s=time.perf_counter() - t0,
                  peak_bytes=torch.cuda.max_memory_allocated(),
                  trees=rf_e.trees)
    log(f"  exact fit of the majority rows, for comparison: "
        f"{info_e['fit_s']:.3f} s, peak device memory "
        f"{info_e['peak_bytes'] / 2**30:.3f} GiB, held-out AUC "
        f"{rf_e.auc(maj_test):.6f}, split_scan launches "
        f"{split_scan.launches}; trees sha256 {tree_digest(rf_e.trees)}")
    return info_a, info_b, info_e


# ---------------------------------------------------------------------------
# Phase 6: the reference's default path (segment backend), pruning,
# multinomial bagging, the seed builder, importances
# ---------------------------------------------------------------------------

def phase6(args, dev, leo_train, maj_train, leo_exact_trees, maj_exact):
    """The reference's default exact path on the card, held against the
    kernel fits of phases 3 and 5, and the options around it; see the
    module docstring.  Returns what PERF.md records."""
    import numpy as np
    import torch
    from repro_torch.core import bagging, presort, tree as tree_lib
    from repro_torch.core.dataset import from_numpy
    from repro_torch.core.reference import build_tree_reference
    from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan
    t_phase = time.perf_counter()
    out = {}
    leo_kernels = {"cat_hist": cat_hist, "breiman": breiman}

    # (a) TreeParams defaults but the depth: the segment backend on Leo
    params = tree_lib.TreeParams(max_depth=args.depth)
    rf_a, out["a"] = run_fit(args, leo_train, params, leo_kernels,
                             "default (a) Leo",
                             idle={"split_scan": split_scan})
    if not same_trees(rf_a.trees, leo_exact_trees):
        fail("default (a): the segment trees differ from phase 3's kernel "
             "trees")
    log("  default (a): the segment trees equal phase 3's kernel trees")
    imp = rf_a.feature_importances()
    if imp.shape != (leo_train.m,) or not np.isfinite(imp).all() \
            or abs(float(imp.sum()) - 1) > 1e-5:
        fail(f"feature_importances: shape {imp.shape}, sum {imp.sum()}")
    top = np.argsort(-imp, kind="stable")[:6]
    out["importances_top"] = {int(j): float(imp[j]) for j in top}
    log(f"  (f) feature_importances of (a), top 6 (column: MDI): "
        f"{json.dumps(out['importances_top'])}; numeric columns "
        f"{[round(float(x), 6) for x in imp[:leo_train.m_num]]}")
    del rf_a

    # (b) the segment engine at m = 16 on the majority rows
    rf_b, out["b"] = run_fit(args, maj_train, params, {},
                             "default (b) majority",
                             idle={"split_scan": split_scan})
    if not same_trees(rf_b.trees, maj_exact["trees"]):
        fail("default (b): the segment trees differ from phase 5's exact "
             "kernel trees")
    log(f"  default (b): the segment trees equal phase 5's exact kernel "
        f"trees; segment {out['b']['fit_s']:.3f} s, peak "
        f"{out['b']['peak_bytes'] / 2**30:.3f} GiB beside kernel "
        f"{maj_exact['fit_s']:.3f} s, peak "
        f"{maj_exact['peak_bytes'] / 2**30:.3f} GiB")
    del rf_b

    # (c) pruning on the Leo rows: leaves of fewer than 2 * PRUNE_MIN in-bag
    # rows close, so rows closed in both trees of the batch pile up by
    # depth 7-8; pruned fits must equal the unpruned ones
    for label, extra, kern in (
            ("exact segment", {}, leo_kernels),
            ("hist", dict(split_mode="hist", num_bins=HIST_BINS),
             {"feat_hist": feat_hist, **leo_kernels})):
        fits = {}
        for frac in (1.0, PRUNE_FRAC):
            p = tree_lib.TreeParams(max_depth=args.depth,
                                    min_records=PRUNE_MIN,
                                    prune_closed_frac=frac, **extra)
            fits[frac] = run_fit(args, leo_train, p, kern,
                                 f"(c) {label}, prune_closed_frac={frac}",
                                 num_trees=TREE_BATCH)
        rows = [lv["rows"] for lv in fits[PRUNE_FRAC][1]["levels"]]
        dropped = [a - b for a, b in zip(rows, rows[1:])]
        log(f"  (c) {label}: rows per level {rows}, dropped before each "
            f"next level {dropped}")
        if not any(dropped):
            fail(f"(c) {label}: no row was pruned")
        if not same_trees(fits[1.0][0].trees, fits[PRUNE_FRAC][0].trees):
            fail(f"(c) {label}: the pruned trees differ from the unpruned")
        log(f"  (c) {label}: pruned trees equal the unpruned trees")
        out[f"c {label}"] = dict(rows=rows, **{
            f"frac={f}": {k: v for k, v in info.items() if k != "levels"}
            for f, (_, info) in fits.items()})
        del fits

    # (d) multinomial bagging at 2^23: the card draws the CPU's counts
    n = leo_train.n
    t0 = time.perf_counter()
    w_dev = bagging.bag_counts_forest(args.seed, range(TREES), n,
                                      "multinomial", dev)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_cpu = bagging.bag_counts_forest(args.seed, range(TREES), n,
                                      "multinomial", "cpu")
    cpu_s = time.perf_counter() - t0
    if not torch.equal(w_dev.cpu(), w_cpu):
        fail("(d) multinomial bag counts on the card differ from the CPU's")
    if not bool((w_cpu.sum(1) == n).all()):
        fail(f"(d) multinomial bag counts sum to {w_cpu.sum(1)}, not {n}")
    log(f"  (d) multinomial bag counts of {TREES} trees x {n} rows: the "
        f"card's equal the CPU's bit for bit and sum to n ({dev_s:.3f} s on "
        f"the card, {cpu_s:.3f} s on the CPU); out-of-bag share "
        f"{float((w_cpu == 0).float().mean()):.6f}")
    del w_dev, w_cpu
    _, out["d"] = run_fit(args, leo_train, tree_lib.TreeParams(
        max_depth=args.depth, bagging="multinomial"), leo_kernels,
        "(d) multinomial Leo", idle={"split_scan": split_scan})

    # (e) the seed builder on the card, one tree of a 2^18-row Leo slice
    k = 1 << 18
    small = from_numpy(leo_train.num[:k], leo_train.cat[:k],
                       leo_train.labels[:k], leo_train.arities)
    p = tree_lib.TreeParams(max_depth=SEED_DEPTH)
    num = torch.as_tensor(small.num, device=dev)
    si = presort.presort_columns(num)
    kw = dict(num=num, cat=torch.as_tensor(small.cat, device=dev),
              labels=torch.as_tensor(small.labels, device=dev),
              sorted_vals=presort.gather_sorted(num, si), sorted_idx=si,
              arities=small.arities, num_classes=small.num_classes,
              params=p, seed=args.seed)
    t0 = time.perf_counter()
    spec, _ = build_tree_reference(tree_idx=0, **kw)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trees, _ = tree_lib.build_forest(tree_indices=[0], **kw)
    torch.cuda.synchronize()
    forest_s = time.perf_counter() - t0
    if not same_trees([spec], trees):
        fail("(e) the seed builder's tree differs from build_forest's")
    out["e"] = dict(seed_s=seed_s, forest_s=forest_s, nodes=spec.num_nodes)
    log(f"  (e) seed builder: depth <= {SEED_DEPTH} on {small.n} Leo rows, "
        f"{spec.num_nodes} nodes in {seed_s:.3f} s, equal to build_forest's "
        f"tree ({forest_s:.3f} s); trees sha256 {tree_digest(trees)}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 6 total {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 7: out-of-core streamed training
# ---------------------------------------------------------------------------

def stream_launch_counts(rf, n_rows: int, chunk: int, max_depth: int):
    """The chunk steps a streamed fit must run, from its trees: each tree
    batch runs one chunk pass per level down to its deepest node depth D,
    over ceil(n / chunk) chunks (no pruning here); every level above
    max_depth builds tables (feat_hist, one launch per chunk for a batch
    of <= 8 trees), the max_depth level sums totals only.  Returns
    (table chunk steps, all chunk steps)."""
    chunks = -(-n_rows // chunk)
    tables = steps = 0
    for t0 in range(0, len(rf.trees), TREE_BATCH):
        D = max(t.max_depth_reached for t in rf.trees[t0:t0 + TREE_BATCH])
        steps += (D + 1) * chunks
        tables += min(D + 1, max_depth) * chunks
    return tables, steps


def stream_fit(args, src, params, label, trees=None, capture=False,
               profile_against=None):
    """One `fit_streamed` of `src` with the launch and chunk-step counters
    and the peak device memory set to 0 just before and read just
    after.  Fails unless feat_hist launched once per table chunk
    step and the trees equal `trees` (when given).  With `capture`, keeps
    the inputs of the last `feat_hist` call of the widest table (a chunk
    of the deepest level), as its wrapper receives them.  With
    `profile_against` (an unprofiled wall of the same fit, seconds) the
    fit runs under the profiler (`profiled`)."""
    import torch
    from repro_torch.core.forest import RandomForest
    from repro_torch.core.level import plan as plan_lib
    from repro_torch.kernels import feat_hist
    from repro_torch.kernels import ops as kops
    captured = {}
    adapter = kops.feature_tables

    def record(bin_of, slots, w, labels, *, B, W, task, num_classes):
        if W >= captured.get("W", 0):
            captured.update(x=bin_of.clone(), slot=slots.clone(),
                            w=w.clone(), y=labels.float(), W=W, B=B,
                            S=kops.stat_dim(num_classes, task))
        return adapter(bin_of, slots, w, labels, B=B, W=W, task=task,
                       num_classes=num_classes)

    def fit():
        return RandomForest(params, num_trees=TREES, seed=args.seed,
                            tree_batch=TREE_BATCH).fit_streamed(
            src, collect_stats=True)

    if capture:
        kops.feature_tables = record
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        feat_hist.launches = 0
        plan_lib._STREAM_CHUNK_CALLS[0] = 0
        t0 = time.perf_counter()
        rf = (fit() if profile_against is None
              else profiled(fit, profile_against))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        kops.feature_tables = adapter
    launches = feat_hist.launches
    steps = plan_lib._STREAM_CHUNK_CALLS[0]
    peak = torch.cuda.max_memory_allocated()
    want_tables, want_steps = stream_launch_counts(rf, src.n,
                                                   src.chunk_size,
                                                   params.max_depth)
    levels = batch_levels(rf, TREE_BATCH, params.leaf_pad)
    log(f"  {label}: {fit_s:.3f} s for {TREES} trees on n={src.n} rows, "
        f"chunk_size={src.chunk_size}; peak device memory "
        f"{peak / 2**20:.1f} MiB; feat_hist launches {launches} (table "
        f"chunk steps {want_tables}), chunk steps {steps} (expected "
        f"{want_steps})")
    for lv in levels:
        log(f"    level depth={lv['depth']} Lp={lv['Lp']} open={lv['open']} "
            f"rows={lv['rows']}: {lv['s'] * 1e3:.3f} ms")
    if launches != want_tables or steps != want_steps:
        fail(f"{label}: feat_hist launched {launches} times for "
             f"{want_tables} table chunk steps, {steps} chunk steps for "
             f"{want_steps}")
    if trees is not None and not same_trees(rf.trees, trees):
        fail(f"{label}: the streamed trees differ from the in-memory trees")
    info = dict(fit_s=fit_s, peak_bytes=peak, launches=launches,
                chunk_steps=steps, chunk=src.chunk_size,
                n=src.n, levels=[{k: lv[k] for k in ("depth", "Lp", "s")}
                                 for lv in levels])
    return rf, info, captured


def check_captured_chunk(args, dev, cap, label):
    """feat_hist on a captured chunk of the deepest level, held bit-equal
    to its plain version and timed beside its bound."""
    from repro_torch.kernels import feat_hist as fh
    T, n = cap["slot"].shape
    m = cap["x"].shape[0]
    r = check_feat_hist(args, dev, None, n, T, m, cap["W"], cap["B"],
                        cap["x"].dtype, "classification", True,
                        inputs=(cap["x"], cap["slot"], cap["w"], cap["y"]))
    r["path"] = "shared" if fh.hist_plan(T, m, n, cap["W"], cap["B"],
                                         cap["S"]).shared else "device"
    log(f"  {label}: feat_hist on a captured chunk of the deepest level "
        f"(W={cap['W']}, {n} rows, {r['path']} path): bit-equal to plain; "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.4f}, index_add_ {r['library_ms']:.3f})")
    return {k: r[k] for k in ("W", "n", "path", "ms", "plain_ms", "bound_ms",
                              "library_ms", "max_abs_err")}


def phase7(args, dev, src_dir, maj_train, hist_trees):
    """Out-of-core streamed training on the card; see the module
    docstring.  Returns what PERF.md records."""
    import numpy as np
    import torch
    from repro_torch.core import checkpoint, presort
    from repro_torch.core.dataset import ArrayRowSource, MemmapRowSource
    from repro_torch.core.forest import RandomForest
    t_phase = time.perf_counter()
    params = hist_params(args)
    n = maj_train.n
    work = ROOT / "build" / "repro_torch" / "stream"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}
    try:
        # (a) the bin cache on disk, built by the streaming quantizer
        t0 = time.perf_counter()
        src = MemmapRowSource.from_numpy(
            maj_train.num, maj_train.labels, num_bins=HIST_BINS,
            path=work / "bins.npy", chunk_size=STREAM_CHUNKS[0])
        out["build_s"] = time.perf_counter() - t0
        num = torch.as_tensor(maj_train.num, device=dev)
        sv = presort.gather_sorted(num, presort.presort_columns(num))
        bins, edges = presort.quantize(num, sv, HIST_BINS)
        del num, sv
        if not np.array_equal(edges.cpu().numpy(), src.edges):
            fail("(a) the streaming quantizer's edges differ from the "
                 "in-memory quantizer's")
        if not np.array_equal(bins.cpu().numpy(), src.bins_block(0, n)):
            fail("(a) the cache's bins differ from the in-memory bins")
        del bins, edges
        log(f"  (a) MemmapRowSource cache of {n} rows x {src.m_num} columns "
            f"({(work / 'bins.npy').stat().st_size / 2**20:.1f} MiB) built "
            f"in {out['build_s']:.3f} s; edges and bins equal the in-memory "
            f"quantizer's")

        # (b) the two chunk sizes against phase 5 (b)'s in-memory trees
        for chunk in STREAM_CHUNKS:
            src.chunk_size = min(chunk, n)
            rf, info, cap = stream_fit(args, src, params,
                                       f"(b) streamed, chunk {chunk}",
                                       trees=hist_trees, capture=True)
            info["captured"] = check_captured_chunk(args, dev, cap,
                                                    f"(b) chunk {chunk}")
            del cap
            out[f"b {chunk}"] = info
            if chunk == STREAM_CHUNKS[0]:
                b_trees = rf.trees
                _, again, _ = stream_fit(
                    args, src, params, f"(b) repeat, chunk {chunk}",
                    trees=b_trees,
                    profile_against=info["fit_s"] if args.profile else None)
                out[f"b {chunk}"]["repeat_s"] = again["fit_s"]
            del rf
        log("  (b) the streamed trees equal phase 5 (b)'s in-memory trees at "
            "both chunk sizes, and the repeat's")

        # (c) bagging="none": device memory bounded by the chunk, not n
        none = dataclasses.replace(params, bagging="none")
        peaks = {}
        for rows in (n >> 1, n):
            sub = ArrayRowSource(src.bins_block(0, rows), src.edges,
                                 maj_train.labels[:rows], num_classes=2,
                                 chunk_size=min(STREAM_CHUNKS[0], rows))
            _, info, _ = stream_fit(args, sub, none,
                                    f"(c) bagging=none, n={rows}")
            peaks[rows] = info["peak_bytes"]
            out[f"c {rows}"] = info
            del sub
        spread = abs(peaks[n] - peaks[n >> 1])
        log(f"  (c) peak device memory {peaks[n >> 1] / 2**20:.1f} MiB at "
            f"n={n >> 1}, {peaks[n] / 2**20:.1f} MiB at n={n}: they differ "
            f"by {spread / 2**20:.2f} MiB")
        if spread >= PEAK_SPREAD:
            fail(f"(c) the peaks differ by {spread / 2**20:.1f} MiB, not "
                 f"less than {PEAK_SPREAD / 2**20:.0f}")

        # (d) SIGKILL after a level snapshot, then resume here
        src.chunk_size = STREAM_CHUNKS[0]
        np.save(work / "edges.npy", src.edges)
        np.save(work / "labels.npy", src.labels)
        ck = work / "ckpt"
        code = f"""
import sys
sys.path.insert(0, {str(src_dir)!r})
import numpy as np
from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import MemmapRowSource
from repro_torch.core.forest import RandomForest
from repro_torch.testing import faults
src = MemmapRowSource({str(work / 'bins.npy')!r},
                      np.load({str(work / 'edges.npy')!r}),
                      np.load({str(work / 'labels.npy')!r}), num_classes=2,
                      chunk_size={src.chunk_size})
faults.arm_kill_after_snapshots({STREAM_KILL_AFTER})
RandomForest(tree_lib.TreeParams(**{dataclasses.asdict(params)!r}),
             num_trees={TREES}, seed={args.seed},
             tree_batch={TREE_BATCH}).fit_streamed(
    src, checkpoint_dir={str(ck)!r})
raise SystemExit("the fit was not killed")
"""
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=600)
        out["killed_s"] = time.perf_counter() - t0
        if proc.returncode != -signal.SIGKILL:
            fail(f"(d) the checkpointed fit ended with {proc.returncode}, "
                 f"not SIGKILL:\n{proc.stderr[-3000:]}")
        snap = checkpoint.StreamCheckpointer(ck).load_snapshot(
            list(range(TREE_BATCH)))
        if snap is None or int(snap["next_depth"]) != STREAM_KILL_AFTER:
            fail("(d) the killed fit left no snapshot of its third level")
        ck0 = checkpoint.CKPT_WALL[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rf = RandomForest(params, num_trees=TREES, seed=args.seed,
                          tree_batch=TREE_BATCH).fit_streamed(
            src, checkpoint_dir=str(ck), resume=True)
        torch.cuda.synchronize()
        out["resume_s"] = time.perf_counter() - t0
        out["resume_ckpt_s"] = checkpoint.CKPT_WALL[0] - ck0
        if not same_trees(rf.trees, b_trees):
            fail("(d) the resumed forest differs from (b)'s")
        log(f"  (d) the checkpointed fit was killed by SIGKILL after "
            f"{STREAM_KILL_AFTER} level snapshots ({out['killed_s']:.3f} s, "
            f"process start included); resume=True finished the forest in "
            f"{out['resume_s']:.3f} s ({out['resume_ckpt_s']:.3f} s of it "
            f"checkpoint writes), equal to (b)'s trees")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 7 total {out['phase_s']:.1f} s")
    log(f"  phase 7 {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 8: boosted trees (GBTModel) on the card
# ---------------------------------------------------------------------------

def gbt_recorders(captured):
    """Recorders around the port's kernel adapters that keep, for each
    kernel, the inputs of its latest call as its wrapper receives them
    (after a fit: the deepest level of the last round).  Returns
    (install, restore)."""
    import torch
    from repro_torch.kernels import ops as kops
    orig = (kops.split_scan_supersplit, kops.categorical_tables,
            kops.feature_tables)

    def own(t):                 # a contiguous copy the fit cannot change
        return t.clone(memory_format=torch.contiguous_format)

    def record_ss(sorted_vals, sorted_idx, leaf_of, w, labels, cand, totals,
                  impurity="gini", task="classification", min_records=1.0):
        captured["split_scan"] = dict(
            ins=(sorted_vals.contiguous(), sorted_idx.contiguous(),
                 own(leaf_of), w.contiguous(),
                 labels.to(torch.float32).contiguous(), own(cand),
                 own(totals)),
            kw=dict(impurity=impurity, task=task, min_records=min_records))
        return orig[0](sorted_vals, sorted_idx, leaf_of, w, labels, cand,
                       totals, impurity, task, min_records)

    def record_cat(cat_cols, leaf_of, w, labels, *, V, Lp, task,
                   num_classes, slot=None, m_prime=None):
        captured["cat_hist"] = dict(
            ins=(cat_cols.contiguous(), own(leaf_of), w.contiguous(),
                 labels.to(torch.float32).contiguous()),
            L1=Lp + 1, V=V, task=task,
            slot=None if slot is None else own(slot), m_prime=m_prime)
        return orig[1](cat_cols, leaf_of, w, labels, V=V, Lp=Lp, task=task,
                       num_classes=num_classes, slot=slot, m_prime=m_prime)

    def record_feat(bin_of, slots, w, labels, *, B, W, task, num_classes):
        captured["feat_hist"] = dict(
            ins=(bin_of.contiguous(), own(slots.to(torch.int32)),
                 w.contiguous(), labels.to(torch.float32).contiguous()),
            W=W, B=B, task=task)
        return orig[2](bin_of, slots, w, labels, B=B, W=W, task=task,
                       num_classes=num_classes)

    def install():
        (kops.split_scan_supersplit, kops.categorical_tables,
         kops.feature_tables) = record_ss, record_cat, record_feat

    def restore():
        (kops.split_scan_supersplit, kops.categorical_tables,
         kops.feature_tables) = orig
    return install, restore


def variance_gains64(ins, kw, t, j, h):
    """Every split of leaf h of tree t on column j, as Alg. 1 scores it
    (a row whose value passes the previous in-bag value of its leaf,
    `min_records` on both sides), with the kernel's float32 row stats and
    totals summed in float64: (thresholds in float32, float64 gains)."""
    import torch
    from repro_torch.core import splits
    vals, sidx, leaf, w, y, cand, totals = ins
    si = sidx[j].long()
    a, lf, ww = vals[j], leaf[t, si], w[t, si]
    act = (lf == h) & (ww > 0) & bool(cand[t, j, h])
    a, ww, yy = a[act], ww[act], y[si][act]
    st = splits.row_stats(yy, ww, 3, "regression").double()    # float32 rows
    left = st.cumsum(0) - st
    right = totals[t, h].double() - left
    pv = torch.cat([a.new_full((1,), float("-inf")), a[:-1]])
    ok = torch.isfinite(pv) & (a > pv) \
        & (left[:, 0] >= kw["min_records"]) \
        & (right[:, 0] >= kw["min_records"])
    gain = splits.split_gain(left, right, "variance")
    return ((a + pv) * 0.5)[ok], gain[ok]


def check_captured_split_scan(args, cap):
    """split_scan on a captured regression level against its plain
    version: finite masks equal and gains within phase 2's bound (1e-6 of
    the leaves' stat sums).  Where the two pick other thresholds (gains
    tied to float32 rounding, summed in other orders), each pick's gain,
    summed in float64 (`variance_gains64`), must be within the same bound
    of the best split's.  Timed beside its bound."""
    import torch
    from repro_torch.kernels import split_scan as ss
    ins, kw = cap["ins"], cap["kw"]
    if kw["impurity"] != "variance":
        fail(f"split_scan capture: a {kw['impurity']} level, not variance")
    gk, tk = ss.split_scan(*ins, **kw)
    gp, tp = ss.split_scan_plain(*ins, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(gp)
    if not torch.equal(torch.isfinite(gk), fin):
        fail("split_scan on a captured GBT level: finite masks differ")
    err = (gk[fin] - gp[fin]).abs().max().item() if fin.any() else 0.0
    thr_same = (tk[fin] == tp[fin]).float().mean().item() if fin.any() \
        else 1.0
    scale = ins[6].abs().max().item()
    tol = 1e-6 * max(scale, 1.0)
    if err > tol:
        fail(f"split_scan on a captured GBT level: max gain err {err} "
             f"(scale {scale})")
    worst = 0.0
    for t, j, h in (fin & (tk != tp)).nonzero().tolist():
        taus, g64 = variance_gains64(ins, kw, t, j, h)
        best = g64.max().item()
        for pick in (tk[t, j, h], tp[t, j, h]):
            at = g64[taus == pick]
            if not at.numel():
                fail(f"split_scan (tree {t}, column {j}, leaf {h}): "
                     f"threshold {pick.item()} is no split of the leaf")
            worst = max(worst, best - at.max().item())
    if worst > tol:
        fail(f"split_scan on a captured GBT level: a picked threshold's "
             f"float64 gain is {worst} below the best split's (bound {tol})")
    bit_equal = torch.equal(gk, gp) and torch.equal(tk, tp)
    del gk, tk, gp, tp
    T, n = ins[2].shape
    m, L1 = ins[0].shape[0], ins[6].shape[1]
    act = (((ins[2] > 0) & (ins[3] > 0))[:, None, :]
           & torch.gather(ins[5], 2, ins[2].long()[:, None, :].expand(
               T, m, n))).sum().item()
    b, by = bound_ms(ss.bound_bytes(T, m, n, L1, 3), act * 40)
    row = dict(n=n, T=T, m=m, L1=L1, impurity=kw["impurity"],
               max_abs_err=err, same_thr=thr_same, bit_equal=bit_equal,
               tied_pick_gap=worst,
               ms=cuda_ms(lambda: ss.split_scan(*ins, **kw)),
               plain_ms=cuda_ms(lambda: ss.split_scan_plain(*ins, **kw),
                                runs=1),
               bound_ms=b, bound_by=by, library_ms=None)
    torch.cuda.empty_cache()
    return row


def check_gbt_kernels(args, captured, kernels, label):
    """Each kernel the fit launched, held against its plain version on the
    inputs captured from the fit's deepest level of its last round (to
    phase 2's standard for regression stats) and timed there."""
    rows = {}
    for name in kernels:
        cap = captured.get(name)
        if cap is None:
            fail(f"{label}: no {name} call was captured")
        if name == "split_scan":
            r = check_captured_split_scan(args, cap)
        elif name == "cat_hist":
            x, leaf, w, y = cap["ins"]
            r = check_cat_hist(args, None, None, x.shape[1], leaf.shape[0],
                               x.shape[0], cap["L1"], cap["V"], cap["task"],
                               True, inputs=cap["ins"], slot=cap["slot"],
                               m_prime=cap["m_prime"])
        else:
            x, slot, w, y = cap["ins"]
            r = check_feat_hist(args, None, None, x.shape[1], slot.shape[0],
                                x.shape[0], cap["W"], cap["B"], x.dtype,
                                cap["task"], True, inputs=cap["ins"])
        rows[name] = {k: r[k] for k in ("n", "T", "m", "L1", "V", "W",
                                        "max_abs_err", "bit_equal", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms") if k in r}
        log(f"  {label}: {name} on the deepest level of the last round "
            f"{json.dumps(rows[name])}")
    return rows


def gbt_fit(args, ds, params, kernels, idle, label):
    """Fit `params` on `ds` through `GBTModel.fit` with the launch counters
    and the level-step counter set to 0 just before and read just after:
    every kernel of `kernels` must launch once per level step, no kernel
    of `idle` at all.  A repeat fit (recorders around the kernel adapters)
    must grow identical trees; each kernel is then held against its plain
    version on the repeat's captured deepest level (`check_gbt_kernels`).
    With --profile a third fit runs under the profiler."""
    import torch
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.gbt import GBTModel

    def fit():
        return GBTModel(params).fit(ds)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (*kernels.values(), *idle.values()):
        mod.launches = 0
    tree_lib._BATCH_STEP_CALLS[0] = 0
    t0 = time.perf_counter()
    gbt = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = tree_lib._BATCH_STEP_CALLS[0]
    launches = {name: mod.launches for name, mod in kernels.items()}
    idle_launches = {name: mod.launches for name, mod in idle.items()}
    peak = torch.cuda.max_memory_allocated()
    digest = tree_digest(gbt.trees)
    log(f"  {label} fit: {fit_s:.3f} s for {params.num_rounds} rounds "
        f"({fit_s / params.num_rounds * 1e3:.3f} ms a round) of depth <= "
        f"{params.max_depth} on n={ds.n} rows x {ds.m} columns; {steps} "
        f"level steps; peak device memory {peak / 2**30:.3f} GiB")
    log(f"  launches: {json.dumps(launches)}; not on this path: "
        f"{json.dumps(idle_launches)}")
    log(f"  nodes per round: {[t.num_nodes for t in gbt.trees]}; trees "
        f"sha256 {digest}")
    if any(v != steps for v in launches.values()) or not steps:
        fail(f"{label}: a kernel of the path did not launch once per level "
             f"step ({steps}): {launches}")
    if any(idle_launches.values()):
        fail(f"{label}: launched a kernel off its path: {idle_launches}")
    if peak > 60 * 2**30:
        fail(f"{label}: peak device memory {peak / 2**30:.1f} GiB passes "
             f"60 GiB")
    captured = {}
    install, restore = gbt_recorders(captured)
    install()
    try:
        t0 = time.perf_counter()
        again = fit()
        torch.cuda.synchronize()
        repeat_s = time.perf_counter() - t0
    finally:
        restore()
    log(f"  repeat {label} fit (kernel inputs recorded): {repeat_s:.3f} s")
    if not same_trees(gbt.trees, again.trees):
        fail(f"a repeat {label} fit grew different trees")
    del again
    log(f"  repeat {label} fit grew identical trees")
    if args.profile:                # a third fit, against the repeat's wall
        profiled(fit, repeat_s)
    rows = check_gbt_kernels(args, captured, kernels, label)
    del captured
    torch.cuda.empty_cache()
    return gbt, dict(fit_s=fit_s, repeat_s=repeat_s, steps=steps,
                     peak_bytes=peak, launches=launches, sha256=digest,
                     kernels=rows)


def phase8(args, dev, train, test):
    """Boosted trees on the card; see the module docstring.  Returns
    (fit (a)'s model, what PERF.md records)."""
    import numpy as np
    import torch
    from repro_torch.core.dataset import from_numpy
    from repro_torch.core.forest import binary_auc
    from repro_torch.core.gbt import GBTModel, GBTParams
    from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan
    t_phase = time.perf_counter()
    out = {"fits": {}}
    reg_train = from_numpy(train.num, train.cat, regression_target(train),
                           train.arities, task="regression")
    y_test = regression_target(test)
    fits = (
        ("(a) logistic", train, GBTParams(loss="logistic"),
         {"cat_hist": cat_hist}),
        ("(b) logistic kernel", train,
         GBTParams(loss="logistic", backend="kernel"),
         {"split_scan": split_scan, "cat_hist": cat_hist}),
        ("(c) logistic hist", train,
         GBTParams(loss="logistic", split_mode="hist"),
         {"feat_hist": feat_hist, "cat_hist": cat_hist}),
        ("(d) squared", reg_train, GBTParams(loss="squared"),
         {"cat_hist": cat_hist}))
    every = {"split_scan": split_scan, "cat_hist": cat_hist,
             "feat_hist": feat_hist, "breiman": breiman}
    model_a = None
    for label, ds, params, kern in fits:
        idle = {k: v for k, v in every.items() if k not in kern}
        gbt, info = gbt_fit(args, ds, params, kern, idle, f"GBT {label}")
        f = gbt.predict_raw(test.num, test.cat).cpu().numpy()
        if not np.isfinite(f).all() or f.shape != (test.n,):
            fail(f"GBT {label}: predict_raw gave {f.shape} / non-finite")
        if params.loss == "logistic":
            info["auc"] = binary_auc(f, np.asarray(test.labels))
            log(f"  GBT {label}: held-out AUC {info['auc']:.6f}")
            if not info["auc"] > 0.6:
                fail(f"GBT {label}: AUC {info['auc']} is no better than "
                     f"chance")
        else:
            info["mse"] = float(((f - y_test) ** 2).mean())
            info["prior_mse"] = float(((gbt.base_score - y_test) ** 2).mean())
            log(f"  GBT {label}: held-out MSE {info['mse']:.6f} against the "
                f"prior's {info['prior_mse']:.6f}")
            if not info["mse"] < info["prior_mse"]:
                fail(f"GBT {label}: held-out MSE is not below the prior's")
        out["fits"][label] = info
        if model_a is None:
            model_a = gbt
        else:
            del gbt
        torch.cuda.empty_cache()

    # (e) a 2^16-row cut: the card's rounds equal the CPU port's
    k = GBT_SMALL_ROWS
    for loss, y, task in (("logistic", train.labels[:k], "classification"),
                          ("squared", regression_target(train)[:k],
                           "regression")):
        small = from_numpy(train.num[:k], train.cat[:k], y, train.arities,
                           task=task)
        p = GBTParams(loss=loss, num_rounds=GBT_SMALL_ROUNDS,
                      min_records=10)
        t0 = time.perf_counter()
        gpu = GBTModel(p).fit(small)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = GBTModel(p, device="cpu").fit(small)
        cpu_s = time.perf_counter() - t0
        if not same_trees(gpu.trees, cpu.trees):
            fail(f"(e) {loss}: the card's rounds differ from the CPU's")
        q_num, q_cat = test.num[:k], test.cat[:k]
        if not torch.equal(gpu.predict_raw(q_num, q_cat).cpu(),
                           cpu.predict_raw(q_num, q_cat)):
            fail(f"(e) {loss}: the card's predict_raw differs from the "
                 f"CPU's")
        out[f"e {loss}"] = dict(gpu_s=gpu_s, cpu_s=cpu_s)
        log(f"  (e) {loss}, {GBT_SMALL_ROUNDS} rounds on {k} rows: the "
            f"card's trees equal the CPU's node for node and predict_raw "
            f"bit for bit ({gpu_s:.3f} s on the card, {cpu_s:.3f} s on the "
            f"CPU)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 8 total {out['phase_s']:.1f} s")
    log(f"  phase 8 {json.dumps(out)}")
    return model_a, out


# ---------------------------------------------------------------------------
# Phase 9: serving (ForestServer) on the card
# ---------------------------------------------------------------------------

def latency_ms(fn, calls: int) -> list:
    """Host milliseconds of each of `calls` calls of `fn` (each ends in a
    host copy of its answer, so a call waits for the card), sorted."""
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def percentile(sorted_ms: list, q: float) -> float:
    return sorted_ms[min(len(sorted_ms) - 1, int(q * len(sorted_ms)))]


def phase9(args, dev, exact_trees, test, gbt_a):
    """Serving on the card; see the module docstring.  Returns what
    PERF.md records."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.core.forest import PackedForest, pack_trees
    from repro_torch.serve.engine import ForestServer, InvalidRequest
    t_phase = time.perf_counter()
    out = {}
    work = ROOT / "build" / "repro_torch" / "serve"
    work.mkdir(parents=True, exist_ok=True)
    path = work / "forest.npz"
    try:
        pack_trees(exact_trees, device="cpu").save(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = ForestServer.load(path, m_cat=test.m_cat, arities=test.arities,
                                warm_batch_sizes=(1, 1024))
        out["load_s"] = time.perf_counter() - t0
        cpu = PackedForest.load(path, device="cpu")
        num, cat = test.num, test.cat
        t0 = time.perf_counter()
        first = srv.predict(num[:1], cat[:1]).cpu()
        out["first_call_ms"] = (time.perf_counter() - t0) * 1e3

        # (a) the card's answers equal the CPU's, bit for bit
        for b in (1, 1024, 1 << 16):
            got = srv.predict(num[:b], cat[:b]).cpu()
            if not torch.equal(got, cpu.predict_proba(num[:b], cat[:b])):
                fail(f"(a) the server's answers for {b} rows differ from "
                     f"the CPU PackedForest's")
        log(f"  (a) ForestServer on the card ({srv.packed.num_trees} trees, "
            f"loaded and warmed at batch 1 and 1024 in {out['load_s']:.3f} "
            f"s): answers for 1, 1024 and 65536 held-out rows equal the CPU "
            f"PackedForest's bit for bit")

        # (b) every malformed-request class raises; the server keeps serving
        good_num, good_cat = num[:2], cat[:2]
        want = srv.predict(good_num, good_cat).cpu()
        bad_nan = good_num.copy()
        bad_nan[1, 2] = np.nan
        bad_neg = good_cat.copy()
        bad_neg[0, 3] = -1
        bad_hi = good_cat.copy()
        bad_hi[1, 78] = test.arities[78]
        cases = {
            "numeric shape": (good_num[:, :2], good_cat),
            "non-finite": (bad_nan, good_cat),
            "missing categorical row": (good_num, None),
            "integer dtype": (good_num, good_cat.astype(np.float32)),
            "categorical shape": (good_num, good_cat[:, :5]),
            "batch mismatch": (good_num, cat[:3]),
            "negative id": (good_num, bad_neg),
            "id >= arity": (good_num, bad_hi)}
        for name, (n_in, c_in) in cases.items():
            try:
                srv.predict(n_in, c_in)
            except InvalidRequest as e:
                msg = str(e)
            else:
                fail(f"(b) a request with a bad {name} was answered")
            if not torch.equal(srv.predict(good_num, good_cat).cpu(), want):
                fail(f"(b) after a bad {name}, a valid request answered "
                     f"otherwise")
            log(f"  (b) {name}: InvalidRequest ({msg[:70]}); the next valid "
                f"request answered as before")

        # (c) latency and throughput
        one_num, one_cat = num[5:6], cat[5:6]
        lat = latency_ms(lambda: srv.predict(one_num, one_cat).cpu(),
                         SERVE_CALLS)
        out.update(p50_ms=percentile(lat, 0.5), p99_ms=percentile(lat, 0.99),
                   max_ms=lat[-1])
        for b in (1024, 1 << 16):
            srv.predict(num[:b], cat[:b]).cpu()
            ms = latency_ms(lambda: srv.predict(num[:b], cat[:b]).cpu(), 10)
            out[f"rows_per_s_{b}"] = b / (percentile(ms, 0.5) / 1e3)
            out[f"batch_{b}_p50_ms"] = percentile(ms, 0.5)
        log(f"  (c) first call after load {out['first_call_ms']:.3f} ms; "
            f"single row over {SERVE_CALLS} calls: p50 "
            f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms, max "
            f"{out['max_ms']:.3f} ms; batch 1024: "
            f"{out['rows_per_s_1024']:.0f} rows/s; batch 65536: "
            f"{out['rows_per_s_65536']:.0f} rows/s")
        del first, srv, cpu

        # (d) GBT (a)'s predict_raw on the card, against the CPU's
        gbt_cpu = dc.replace(gbt_a, device="cpu", packed=None)
        rows = 1 << 20
        q_num, q_cat = num[:rows], cat[:rows]
        gbt_a.predict_raw(q_num[:1], q_cat[:1]).cpu()
        lat = latency_ms(lambda: gbt_a.predict_raw(one_num, one_cat).cpu(),
                         SERVE_CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = gbt_a.predict_raw(q_num, q_cat).cpu()
        out["gbt_rows_s"] = time.perf_counter() - t0
        out["gbt_p50_ms"] = percentile(lat, 0.5)
        out["gbt_p99_ms"] = percentile(lat, 0.99)
        if not torch.equal(f, gbt_cpu.predict_raw(q_num, q_cat)):
            fail("(d) GBT (a)'s predict_raw on the card differs from the "
                 "CPU's")
        log(f"  (d) GBT (a) predict_raw ({len(gbt_a.trees)} rounds): single "
            f"row p50 {out['gbt_p50_ms']:.3f} ms, p99 "
            f"{out['gbt_p99_ms']:.3f} ms; {rows} rows in "
            f"{out['gbt_rows_s'] * 1e3:.3f} ms, equal to the CPU's bit for "
            f"bit")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 9 total {out['phase_s']:.1f} s")
    log(f"  phase 9 {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 10: sharded training across ranks (torch.distributed over gloo)
# ---------------------------------------------------------------------------

def regression_hist_params(args):
    from repro_torch.core import tree as tree_lib
    return tree_lib.TreeParams(max_depth=args.depth, backend="kernel",
                               split_mode="hist", num_bins=HIST_BINS,
                               task="regression", impurity="variance")


def collective_levels(entries) -> list:
    """A mesh log per level: {"op@axis": [calls, bytes, seconds]}."""
    out = {}
    for e in entries:
        cell = out.setdefault(e["level"], {}).setdefault(
            f"{e['op']}@{e['axis']}", [0, 0, 0.0])
        cell[0] += 1
        cell[1] += e["bytes"]
        cell[2] += e["seconds"]
    return [out[k] for k in sorted(out)]


def expected_hist_bytes(rf, F: int) -> list:
    """Per level step, the bytes the hist engine's one all-reduce must
    carry: the batch's T trees times the widest tree's
    `LevelStats.hist_table_bytes` (the batch's padded frontier), over the
    F column owners."""
    out = []
    for t0 in range(0, len(rf.trees), TREE_BATCH):
        logs = rf.level_stats[t0:t0 + TREE_BATCH]
        for d in sorted({s.depth for log in logs for s in log}):
            widest = max(s.hist_table_bytes for log in logs for s in log
                         if s.depth == d)
            out.append(len(logs) * widest // F)
    return out


def dist_fit(mesh, fit, kernels) -> tuple:
    """One sharded fit on this rank with the launch counters, level-step
    counters, the mesh's collective log and the peak device memory set to
    0 just before and read just after.  Returns (info, forest)."""
    import torch
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.level import plan as plan_lib
    for mod in kernels.values():
        mod.launches = 0
    tree_lib._BATCH_STEP_CALLS[0] = 0
    plan_lib._STREAM_CHUNK_CALLS[0] = 0
    mesh.reset_log()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rf = fit()
    torch.cuda.synchronize()
    info = dict(wall_s=time.perf_counter() - t0,
                sha256=tree_digest(rf.trees),
                launches={k: m.launches for k, m in kernels.items()},
                steps=tree_lib._BATCH_STEP_CALLS[0],
                chunk_steps=plan_lib._STREAM_CHUNK_CALLS[0],
                peak_bytes=torch.cuda.max_memory_allocated(),
                levels=collective_levels(mesh.log))
    return info, rf


def shard_capture(kind: str, fit, own_cols: bool = False):
    """`fit` wrapped so that it keeps the SHARD_CHECK_CALL-th call of the
    `kops` adapter `kind` ("feature_tables" or "categorical_tables") as
    this rank's engine makes it: its shard of rows and columns, and for a
    regression forest the global scales with `fixed=True`.  The class-list
    rows are copied; the column block is held as given (the dataset's own
    tensor, which the fit leaves as it is, so the fit's peak stays its
    own) unless `own_cols` (a streamed fit refills its chunk buffers).
    Returns (wrapped fit, held list)."""
    from repro_torch.kernels import ops as kops
    adapter = getattr(kops, kind)
    held, calls = [], [0]

    def record(cols, rows, w, labels, **kw):
        if calls[0] == SHARD_CHECK_CALL:
            held.append(dict(cols=cols.clone() if own_cols else cols,
                             rows=rows.clone(), w=w.clone(),
                             labels=labels.clone(), kw=dict(kw)))
        calls[0] += 1
        return adapter(cols, rows, w, labels, **kw)

    def run():
        setattr(kops, kind, record)
        try:
            return fit()
        finally:
            setattr(kops, kind, adapter)
    return run, held


def check_shard_call(kind: str, held: list) -> dict:
    """The kept call's kernel wrapper against its plain version on the same
    card tensors, bit for bit (int64 sums when the call asked for
    `fixed=True`).  Launches made here come after the fit's counts were
    read."""
    import torch
    from repro_torch.kernels import cat_hist, feat_hist
    from repro_torch.kernels import ops as kops
    if len(held) != 1:
        return dict(equal=False, error=f"no call {SHARD_CHECK_CALL} kept")
    c = held.pop()
    kw = c["kw"]
    S = kops.stat_dim(kw["num_classes"], kw["task"])
    extra = dict(task=kw["task"], scales=kw.get("scales"),
                 fixed=kw.get("fixed", False))
    rows = c["rows"].to(torch.int32).contiguous()
    y = c["labels"].to(torch.float32).contiguous()
    if kind == "feature_tables":
        got = kops.feature_tables(c["cols"], rows, c["w"], y, B=kw["B"],
                                  W=kw["W"], task=kw["task"],
                                  num_classes=kw["num_classes"],
                                  scales=extra["scales"],
                                  fixed=extra["fixed"])
        want = feat_hist.feat_hist_plain(
            c["cols"].contiguous(), rows, c["w"].contiguous(), y, W=kw["W"],
            B=kw["B"], num_stats=S, **extra)
    else:
        slot = kw.get("slot")
        got = kops.categorical_tables(c["cols"], rows, c["w"], y,
                                      V=kw["V"], Lp=kw["Lp"],
                                      task=kw["task"],
                                      num_classes=kw["num_classes"],
                                      scales=extra["scales"],
                                      fixed=extra["fixed"], slot=slot,
                                      m_prime=kw.get("m_prime"))
        want = cat_hist.cat_hist_plain(
            c["cols"].contiguous(), rows, c["w"].contiguous(), y,
            L1=kw["Lp"] + 1, V=kw["V"], num_stats=S, **extra)
        if slot is not None:    # the candidates' tables, at their slots
            n_tab = int((slot >= 0).sum().item())
            got = got[:n_tab]
            want = cat_hist.compact_tables(want, slot, n_tab)
    torch.cuda.synchronize()
    out = dict(equal=bool(got.dtype == want.dtype and torch.equal(got, want)),
               max_abs_err=float((got.double() - want.double()).abs().max()),
               shape=list(got.shape), dtype=str(got.dtype).split(".")[-1],
               rows=int(rows.shape[1]), cols=int(c["cols"].shape[0]),
               scales=extra["scales"], fixed=extra["fixed"])
    del c, got, want
    torch.cuda.empty_cache()
    return out


def dist_worker(args) -> int:
    """One rank of phase 10: join the gloo group, make the rows from
    --seed as the parent does, run fits (b)-(f) on the (2, 2) and (1, 4)
    meshes (every rank) and fit (a) on the (2, 1) mesh (ranks 0 and 1),
    and print one `DIST-RESULT {json}` line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.core import presort, tree as tree_lib
    from repro_torch.core.dataset import ArrayRowSource, from_numpy
    from repro_torch.core.forest import RandomForest
    from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan
    from repro_torch.launch.mesh import make_mesh
    rank, world, store = (int(args.dist_worker[0]), int(args.dist_worker[1]),
                          args.dist_worker[2])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    kernels = {"cat_hist": cat_hist, "feat_hist": feat_hist,
               "split_scan": split_scan, "breiman": breiman}
    cut = 1 << args.train_log2n
    n_all = cut + TEST_ROWS
    out = {"rank": rank, "fits": {}}
    fits = out["fits"]
    try:
        m22 = make_mesh(2, 2, backend="gloo", device=dev, timed=True)
        m14 = make_mesh(1, 4, backend="gloo", device=dev, timed=True)
        m21 = make_mesh(2, 1, backend="gloo", device=dev, ranks=[0, 1],
                        timed=True)
        out["staged"] = sorted(m22.staged)

        def forest(params, ds, **kw):
            return lambda: RandomForest(
                params, num_trees=TREES, seed=args.seed,
                tree_batch=TREE_BATCH).fit(ds, collect_stats=True, **kw)

        maj = majority_dataset(args.seed, n_all)
        maj_train = from_numpy(maj.num[:cut], None, maj.labels[:cut])
        del maj
        hist = hist_params(args)
        # (b) hist with subtraction on (2, 2)
        fit, held = shard_capture("feature_tables", forest(
            hist, maj_train, engine=D.make_hist_sharded_supersplit(m22)))
        fits["b"], rf = dist_fit(m22, fit, kernels)
        fits["b"]["expected_bytes"] = expected_hist_bytes(rf, 2)
        del rf
        fits["b"]["shard_check"] = check_shard_call("feature_tables", held)
        # (c) the 2-D resumable exact scan on (2, 2)
        fits["c"], _ = dist_fit(m22, forest(
            tree_lib.TreeParams(max_depth=args.depth), maj_train,
            engine=D.make_2d_sharded_supersplit(m22)), kernels)
        # (d) fit_streamed from an ArrayRowSource, the sharded hist engine
        num = torch.as_tensor(maj_train.num, device=dev)
        bins, edges = presort.quantize(
            num, presort.gather_sorted(num, presort.presort_columns(num)),
            HIST_BINS)
        del num
        src = ArrayRowSource(bins.cpu().numpy(), edges.cpu().numpy(),
                             np.asarray(maj_train.labels), num_classes=2,
                             chunk_size=STREAM_CHUNKS[0])
        del bins, edges
        fit, held = shard_capture("feature_tables", lambda: RandomForest(
            hist, num_trees=TREES, seed=args.seed,
            tree_batch=TREE_BATCH).fit_streamed(
                src, engine=D.make_hist_sharded_supersplit(m22)),
            own_cols=True)
        fits["d"], rf = dist_fit(m22, fit, kernels)
        fits["d"]["table_chunk_steps"] = stream_launch_counts(
            rf, src.n, src.chunk_size, hist.max_depth)[0]
        del rf, src
        fits["d"]["shard_check"] = check_shard_call("feature_tables", held)
        # (e) a regression hist forest on (2, 2): the fixed-point tables
        reg = from_numpy(maj_train.num, None, regression_target(maj_train),
                         task="regression")
        fit, held = shard_capture("feature_tables", forest(
            regression_hist_params(args), reg,
            engine=D.make_hist_sharded_supersplit(m22)))
        fits["e"], _ = dist_fit(m22, fit, kernels)
        fits["e"]["shard_check"] = check_shard_call("feature_tables", held)
        del reg
        # (f) the 1-bit condition broadcast on (1, 4) against local
        g = np.random.default_rng(args.seed + 10)
        n = maj_train.n
        cols = torch.as_tensor(maj_train.num, device=dev).t().contiguous()
        leaf = torch.as_tensor(g.integers(0, EVAL_LEAVES + 1, n,
                                          dtype=np.int32), device=dev)
        feat = torch.as_tensor(g.integers(0, cols.shape[0], EVAL_LEAVES + 1,
                                          dtype=np.int32), device=dev)
        thr = torch.as_tensor(g.normal(size=EVAL_LEAVES + 1).astype(
            np.float32), device=dev)
        ev = D.make_sharded_evaluate(m14)
        m14.reset_log()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bits = ev(cols, leaf, feat, thr, cols.shape[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lf = leaf.long()
        local = cols.reshape(-1)[feat.long()[lf] * n + torch.arange(
            n, device=dev)] <= thr[lf]
        torch.cuda.synchronize()
        fits["f"] = dict(
            wall_s=t1 - t0, local_s=time.perf_counter() - t1,
            equal=bool(torch.equal(bits, local)),
            sha256=hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest(),
            levels=collective_levels(m14.log))
        del cols, leaf, feat, thr, bits, local, maj_train
        torch.cuda.empty_cache()
        # (a) Leo's defaults on (2, 1): rows only (m_cat = 79 is prime)
        if m21 is not None:
            num, cat, y, arities = leo_dataset(args.seed, n_all)
            leo = from_numpy(num[:cut], cat[:cut], y[:cut], arities)
            del num, cat, y
            fit, held = shard_capture("categorical_tables", forest(
                tree_lib.TreeParams(max_depth=args.depth), leo,
                engine=D.make_2d_sharded_supersplit(m21),
                cat_engine=D.make_categorical_sharded_supersplit(m21)))
            fits["a"], _ = dist_fit(m21, fit, kernels)
            fits["a"]["shard_check"] = check_shard_call(
                "categorical_tables", held)
            del leo
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("DIST-RESULT " + json.dumps(out), flush=True)
    return 0


def dist_refs(args, leo_train, maj_train) -> dict:
    """With --dist, the local card fits that phase 10 holds the sharded
    fits against: phase 6 (a)'s, phase 5 (b)'s and phase 5's exact
    majority fit (on the kernel backend; every exact backend grows the
    same trees)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import cat_hist, feat_hist, split_scan
    _, a = run_fit(args, leo_train, tree_lib.TreeParams(max_depth=args.depth),
                   {"cat_hist": cat_hist}, "default (a) Leo",
                   idle={"split_scan": split_scan})
    _, b = run_fit(args, maj_train, hist_params(args),
                   {"feat_hist": feat_hist}, "hist (b) majority")
    _, c = run_fit(args, maj_train, tree_lib.TreeParams(
        max_depth=args.depth, backend="kernel"), {"split_scan": split_scan},
        "exact majority")
    return {"a": a["sha256"], "b": b["sha256"], "c": c["sha256"]}


def phase10(args, dev, maj_train, refs):
    """Sharded training across DIST_WORLD ranks on this card; see the
    module docstring.  `refs` holds the local fits' sha256: "a" (phase 6
    (a)), "b" (phase 5 (b)), "c" (phase 5's exact majority fit); (e)'s
    local regression fit runs here.  Returns what PERF.md records."""
    import torch
    from repro_torch.core.dataset import from_numpy
    from repro_torch.kernels import feat_hist
    t_phase = time.perf_counter()
    reg = from_numpy(maj_train.num, None, regression_target(maj_train),
                     task="regression")
    _, info_e = run_fit(args, reg, regression_hist_params(args),
                        {"feat_hist": feat_hist}, "regression hist (e) local")
    del reg
    refs = dict(refs, e=info_e["sha256"], d=refs["b"])
    torch.cuda.empty_cache()
    work = ROOT / "build" / "repro_torch" / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--seed",
           str(args.seed), "--train-log2n", str(args.train_log2n), "--depth",
           str(args.depth)] + (["--src", str(args.src)] if args.src else [])
    procs, outs = [], []
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            cmd + ["--dist-worker", str(r), str(DIST_WORLD),
                   str(work / "store")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DIST_WORLD)]
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=DIST_TIMEOUT)
            outs.append(text)
            if p.returncode != 0:
                fail(f"phase 10: rank {r} exited {p.returncode}:\n"
                     f"{text[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r, text in enumerate(outs):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("DIST-RESULT ")]
        if len(lines) != 1:
            fail(f"phase 10: rank {r} printed no result:\n{text[-4000:]}")
        ranks.append(json.loads(lines[0][len("DIST-RESULT "):]))
    log(f"  {DIST_WORLD} ranks on one card over gloo, collectives staged "
        f"through the host: {ranks[0]['staged']}; workers {spawn_s:.1f} s")
    out = {"staged": ranks[0]["staged"], "workers_s": spawn_s, "fits": {}}
    labels = {"a": "(a) leo-2^23 defaults, exact segment + categorical, "
                   "(2, 1)",
              "b": "(b) majority-hist-2^23, (2, 2)",
              "c": "(c) majority exact segment, (2, 2)",
              "d": "(d) majority fit_streamed, chunk 2^20, (2, 2)",
              "e": "(e) majority regression hist, (2, 2)",
              "f": "(f) make_sharded_evaluate, (1, 4)"}
    for key, label in labels.items():
        per = [(r["rank"], r["fits"][key]) for r in ranks if key in r["fits"]]
        if not per:
            fail(f"phase 10 {label}: no rank ran it")
        shas = {f["sha256"] for _, f in per}
        walls = [round(f["wall_s"], 3) for _, f in per]
        rec = dict(ranks=[r for r, _ in per], wall_s=walls)
        if key == "f":
            if not all(f["equal"] for _, f in per) or len(shas) != 1:
                fail(f"phase 10 {label}: sharded bits differ from local "
                     f"evaluation or between ranks")
            rec.update(local_s=[round(f["local_s"], 4) for _, f in per],
                       collectives=per[0][1]["levels"])
            log(f"  {label}: equal to local evaluation on every rank; "
                f"walls {walls} s (local {rec['local_s']} s); collectives "
                f"{json.dumps(rec['collectives'])}")
            out["fits"][key] = rec
            continue
        if len(shas) != 1:
            fail(f"phase 10 {label}: the ranks grew different trees")
        if shas != {refs[key]}:
            fail(f"phase 10 {label}: the sharded trees differ from the "
                 f"local fit's ({shas.pop()[:16]} != {refs[key][:16]})")
        launches = [f["launches"] for _, f in per]
        steps = [f["steps"] for _, f in per]
        want = {"a": "cat_hist", "b": "feat_hist", "d": "feat_hist",
                "e": "feat_hist"}
        for (r, f) in per:
            kern = want.get(key) if key != "d" else None
            if kern and f["launches"][kern] != f["steps"]:
                fail(f"phase 10 {label}: rank {r} launched {kern} "
                     f"{f['launches'][kern]} times in {f['steps']} levels")
            if f["launches"]["breiman"] != (f["steps"] if key == "a" else 0):
                fail(f"phase 10 {label}: rank {r} launched breiman "
                     f"{f['launches']['breiman']} times in {f['steps']} "
                     f"levels")
            if key == "d" and f["launches"]["feat_hist"] != \
                    f["table_chunk_steps"]:
                fail(f"phase 10 {label}: rank {r} launched feat_hist "
                     f"{f['launches']['feat_hist']} times for "
                     f"{f['table_chunk_steps']} table chunks")
            if f["launches"]["split_scan"]:
                fail(f"phase 10 {label}: rank {r} launched split_scan")
        if key in want:         # (c) launches no kernel
            checks = [f["shard_check"] for _, f in per]
            for (r, f), chk in zip(per, checks):
                if key == "e" and not (chk["fixed"] and chk["scales"]):
                    fail(f"phase 10 {label}: rank {r}'s kept call did not "
                         f"take the global scales with fixed=True: {chk}")
                if not chk["equal"]:
                    fail(f"phase 10 {label}: rank {r}'s {want[key]} "
                         f"wrapper differs from its plain version on call "
                         f"{SHARD_CHECK_CALL} of its shard: {chk}")
            log(f"  {label}: {want[key]} bit-equal to its plain version on "
                f"call {SHARD_CHECK_CALL} of every rank's shard: "
                f"{json.dumps(checks[0])}")
            rec["shard_check"] = checks
        if key == "b":
            for r, f in per:
                got = [lv.get("all_reduce_sum@data", [0, 0])[1]
                       for lv in f["levels"]]
                if got != f["expected_bytes"]:
                    fail(f"phase 10 {label}: rank {r}'s all-reduce bytes "
                         f"per level {got} != hist_table_bytes / F "
                         f"{f['expected_bytes']}")
            log(f"  {label}: all-reduce bytes per level equal "
                f"LevelStats.hist_table_bytes / F on every rank: "
                f"{per[0][1]['expected_bytes']}")
        peaks = [round(f["peak_bytes"] / 2**30, 3) for _, f in per]
        coll = {}
        for lv in per[0][1]["levels"]:
            for name, (calls, nbytes, secs) in lv.items():
                c = coll.setdefault(name, [0, 0, 0.0])
                c[0] += calls
                c[1] += nbytes
                c[2] += secs
        rec.update(sha256=per[0][1]["sha256"], peak_gib=peaks,
                   launches=launches, steps=steps,
                   collectives_rank0=coll,
                   levels_rank0=per[0][1]["levels"])
        log(f"  {label}: every rank's trees equal the local fit's "
            f"({refs[key][:16]}); walls {walls} s, peaks {peaks} GiB, "
            f"launches {json.dumps(launches)} in {steps} levels; rank "
            f"{per[0][0]}'s collectives (calls, bytes, s): "
            f"{json.dumps(coll)}")
        for i, lv in enumerate(per[0][1]["levels"]):
            log(f"    level {i}: {json.dumps(lv)}")
        out["fits"][key] = rec
    # the multi-process smoke entry point at its default device, the card
    from repro_torch.launch import multihost_smoke
    t1 = time.perf_counter()
    smoke = multihost_smoke.main(2)
    out["multihost_smoke"] = dict(smoke, seconds=time.perf_counter() - t1)
    log(f"  multihost_smoke.main(2) on the card: {smoke}, "
        f"{out['multihost_smoke']['seconds']:.1f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 10 total {out['phase_s']:.1f} s")
    log(f"  phase 10 {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: LM serving
# ---------------------------------------------------------------------------

def lm_models(cfg, seed: int, dev, cpu: bool = True):
    """`cfg`'s weights drawn from `seed` on the card: (the tree, a model
    on the card, with `cpu` the same weights as a model on the host)."""
    import torch
    from repro_torch.models import transformer
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(gen, cfg)
    card = transformer.Transformer(cfg, params, device=dev)
    return params, card, (transformer.Transformer(cfg, params, device="cpu")
                          if cpu else None)


def lm_cast(params: dict, cfg) -> dict:
    """`params` in the dtypes `cfg` gives each leaf (a bfloat16 config
    keeps its float32 leaves): the tree `init_params` draws for `cfg`."""
    from repro_torch.models import transformer

    def cast(tree, meta):
        return {k: cast(v, meta[k]) if isinstance(v, dict)
                else v.to(meta[k].dtype) for k, v in tree.items()}
    return cast(params, transformer.init_params(None, cfg))


def lm_inputs(cfg, B: int, S: int, seed: int):
    """Prompts (tokens, or float32 embeddings for the stub frontends) and,
    for the latter, one fixed decode-step embedding, made with numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int64)), None
    return (torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))
                             .astype(np.float32)),
            torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model))
                             .astype(np.float32)))


def lm_serve(model, prompts, steps: int, step_embed=None, feed=None):
    """`prefill_step`, then `steps` `decode_step`s on padded caches, each
    fed `feed[s]` (tokens (B,)) when given, else this model's greedy token
    (or the fixed embedding).  Returns (logits (B, 1+steps, V), greedy
    tokens (B, 1+steps)), both on the CPU."""
    import torch
    from repro_torch.launch.serve import pad_caches
    from repro_torch.serve import engine
    dev = model.device
    B, P = prompts.shape[:2]
    lg, caches = engine.prefill_step(model, prompts.to(dev))
    caches = pad_caches(caches, steps)
    logits, toks = [lg.float().cpu()], [engine.greedy_sample(lg).cpu()]
    lens = torch.full((B,), P, dtype=torch.int64, device=dev)
    for s in range(steps):
        if step_embed is not None:
            x = step_embed.to(dev)
        else:
            x = (feed[s] if feed is not None else toks[-1])[:, None].to(dev)
        lg, caches = engine.decode_step(model, caches, x, lens)
        lens = lens + 1
        logits.append(lg.float().cpu())
        toks.append(engine.greedy_sample(lg).cpu())
    return torch.cat(logits, dim=1), torch.stack(toks, dim=1)


def lm_card_vs_cpu(card, cpu, prompts, steps, tol, label, step_embed=None):
    """The CPU serves on its own greedy tokens; the card is fed the CPU's
    tokens, so every step sees the same inputs.  Logits must agree within
    `tol` (atol = rtol); the card's greedy token must equal the CPU's
    except at a step whose CPU top-2 gap is under TIE_GAP (printed as a
    tie); a repeat on the card must give the same bits.  Returns
    (max |dlogit|, ties)."""
    import torch
    lg_c, tok_c = lm_serve(cpu, prompts, steps, step_embed)
    feed = [tok_c[:, s] for s in range(steps)]
    lg_g, tok_g = lm_serve(card, prompts, steps, step_embed, feed)
    err = (lg_g - lg_c).abs().max().item()
    if not torch.allclose(lg_g, lg_c, atol=tol, rtol=tol):
        fail(f"{label}: card logits differ from the CPU's by {err:.3e} "
             f"(tolerance {tol})")
    top2 = torch.topk(lg_c, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    ties = 0
    for b, s in (tok_g != tok_c).nonzero().tolist():
        if gap[b, s] >= TIE_GAP:
            fail(f"{label}: card token {int(tok_g[b, s])} != CPU token "
                 f"{int(tok_c[b, s])} at row {b} step {s} (CPU top-2 gap "
                 f"{float(gap[b, s]):.3e})")
        ties += 1
        log(f"    {label}: tie at row {b} step {s}: card {int(tok_g[b, s])},"
            f" CPU {int(tok_c[b, s])}, CPU top-2 gap {float(gap[b, s]):.2e}")
    again, _ = lm_serve(card, prompts, steps, step_embed, feed)
    if not torch.equal(again, lg_g):
        fail(f"{label}: a repeat on the card gave other logits")
    return err, ties


def lm_decode_from_empty(model, prompts, label):
    """Decoding every prompt position from an empty cache must give the
    full forward's logits (the reference's serving contract; its
    tolerance, atol 5e-3, rtol 1e-2)."""
    import torch
    from repro_torch.models.transformer import init_cache
    x = prompts.to(model.device)
    B, S = x.shape[:2]
    full, _, _ = model.forward(x)
    caches = init_cache(model.cfg, B, S, device=model.device)
    lens = torch.zeros(B, dtype=torch.int64, device=model.device)
    outs = []
    for t in range(S):
        lg, caches = model.decode_step(caches, x[:, t:t + 1], lens)
        lens = lens + 1
        outs.append(lg)
    if not torch.allclose(full, torch.cat(outs, 1), atol=5e-3, rtol=1e-2):
        fail(f"{label}: decode from an empty cache differs from the full "
             f"forward on the card")


def lm_phase_a(args, dev) -> dict:
    """(a): every registered architecture's reduced variant (float32)."""
    import dataclasses as dc
    from repro_torch.configs.base import get_arch, list_archs
    from repro_torch.models.transformer import Transformer
    out = {}
    for i, arch in enumerate(list_archs()):
        t0 = time.perf_counter()
        cfg = get_arch(arch).reduced()
        params, card, cpu = lm_models(cfg, args.seed + i, dev)
        prompts, emb = lm_inputs(cfg, 2, LM_SMALL_P, args.seed + i)
        err, ties = lm_card_vs_cpu(card, cpu, prompts, LM_STEPS, 1e-4,
                                   f"(a) {arch}", emb)
        undropped = (dc.replace(cfg, capacity_factor=8.0) if cfg.num_experts
                     else cfg)
        lm_decode_from_empty(Transformer(undropped, params, device=dev),
                             prompts, f"(a) {arch}")
        out[arch] = dict(max_abs_err=err, ties=ties,
                         s=time.perf_counter() - t0)
        log(f"  (a) {arch}: card == CPU over prefill + {LM_STEPS} decode "
            f"steps (max |dlogit| {err:.2e}, ties {ties}), decode from "
            f"empty == forward, repeat bit-equal; {out[arch]['s']:.2f} s")
    return out


def lm_counts(model) -> dict:
    """What one token's forward needs: the bytes of the weights it reads
    (the embedding table excluded: a token reads one row; MoE experts
    counted as top-k of E) and the multiply-adds of its matmuls."""
    from repro_torch.models import transformer
    cfg = model.cfg
    if any(mix != "attn" for mix, _ in cfg.block_pattern):
        raise ValueError("bounds are written for attention models")
    eb = 2 if cfg.dtype == "bfloat16" else 4
    emb = cfg.vocab_size * cfg.d_model if cfg.input_mode == "tokens" else 0
    head = cfg.d_model * cfg.vocab_size
    active = transformer.active_param_count(model) - emb
    attn_layers = cfg.num_blocks * sum(m == "attn" for m, _ in
                                       cfg.block_pattern)
    return dict(eb=eb, weights=active, blocks=active - head - cfg.d_model,
                head=head, attn_layers=attn_layers,
                kv_row=2 * cfg.num_kv_heads * cfg.hd * eb)


def lm_prefill_bound_ms(model, B: int, P: int) -> float:
    """The larger of 2·(block params)·B·P + the causal attention products
    + the last position's head over 989 TFLOP/s, and the weights read
    once + the caches written over 3.35 TB/s."""
    cfg, c = model.cfg, lm_counts(model)
    win = cfg.sliding_window or P
    keys = sum(min(t + 1, win) for t in range(P))
    flops = (2 * c["blocks"] * B * P + 2 * c["head"] * B
             + c["attn_layers"] * 4 * B * cfg.num_heads * cfg.hd * keys)
    nbytes = c["weights"] * c["eb"] + c["attn_layers"] * B * P * c["kv_row"]
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def lm_decode_bound_ms(model, B: int, lens: list) -> float:
    """Summed over decode steps at cache lengths `lens`: the larger of the
    weights plus the cache rows each step attends read once over 3.35
    TB/s, and its products over 989 TFLOP/s."""
    cfg, c = model.cfg, lm_counts(model)
    total = 0.0
    for n in lens:
        keys = min(n + 1, cfg.sliding_window or n + 1)
        nbytes = (c["weights"] * c["eb"]
                  + c["attn_layers"] * B * keys * c["kv_row"])
        flops = (2 * (c["blocks"] + c["head"]) * B
                 + c["attn_layers"] * 4 * B * cfg.num_heads * cfg.hd * keys)
        total += max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    return total * 1e3


def lm_prefill_timing(model, B: int, P: int, seed: int, label: str,
                      profile: bool = False) -> dict:
    """`prefill_step` of B random prompts of P tokens: median of 3 after a
    warm-up (host clock, each run ends in a device sync); with `profile`
    a fourth run under the profiler."""
    import torch
    from repro_torch.serve import engine
    prompts, _ = lm_inputs(model.cfg, B, P, seed)
    prompts = prompts.to(model.device)
    engine.prefill_step(model, prompts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        lg, caches = engine.prefill_step(model, prompts)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del lg, caches
    ms = sorted(times)[1]
    if profile:
        profiled(lambda: engine.prefill_step(model, prompts), ms / 1e3)
    r = dict(B=B, P=P, ms=ms, tokens_per_s=B * P / ms * 1e3,
             bound_ms=lm_prefill_bound_ms(model, B, P),
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"  {label} prefill B={B} x P={P}: {ms:.2f} ms "
        f"({r['tokens_per_s']:.0f} tokens/s), bound {r['bound_ms']:.3f} ms, "
        f"peak {r['peak_gib']:.2f} GiB")
    return r


def lm_decode_timing(model, B: int, seed: int, label: str,
                     profile: bool = False) -> dict:
    """LM_DECODE_STEPS greedy `decode_step`s at batch B ending at
    LM_MAX_SEQ: the caches are filled by a prefill (LM_PREFILL_CHUNK
    sequences at a time); each timed step ends in a device sync.
    Tokens/s, p50/p99 ms a step, peak memory, bound; with `profile`,
    LM_PROFILE_STEPS more steps (at the full cache, which they no longer
    write) under the profiler."""
    import torch
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve import engine
    dev, steps = model.device, LM_DECODE_STEPS
    P0 = LM_MAX_SEQ - steps
    prompts, _ = lm_inputs(model.cfg, B, P0, seed)
    caches = init_cache(model.cfg, B, LM_MAX_SEQ, device=dev)
    tok = torch.empty(B, dtype=torch.int64, device=dev)
    for b0 in range(0, B, LM_PREFILL_CHUNK):
        b1 = min(B, b0 + LM_PREFILL_CHUNK)
        lg, part = engine.prefill_step(model, prompts[b0:b1].to(dev))
        for pos, c in part.items():
            for name, t in c.items():
                caches[pos][name][:, b0:b1, :P0] = t
        tok[b0:b1] = engine.greedy_sample(lg)
        del lg, part
    lens = torch.full((B,), P0, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        lg, caches = engine.decode_step(model, caches, tok[:, None], lens)
        tok, lens = engine.greedy_sample(lg), lens + 1
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    total = sum(ms)
    if profile:
        def more():
            nonlocal tok, caches
            for _ in range(LM_PROFILE_STEPS):
                lg, caches = engine.decode_step(model, caches, tok[:, None],
                                                lens)
                tok = engine.greedy_sample(lg)
        profiled(more, sum(ms[-LM_PROFILE_STEPS:]) / 1e3)
    ms.sort()
    r = dict(B=B, steps=steps, start_len=P0, ms_total=total,
             tokens_per_s=B * steps / total * 1e3, p50_ms=percentile(ms, 0.5),
             p99_ms=percentile(ms, 0.99),
             bound_ms=lm_decode_bound_ms(model, B,
                                         list(range(P0, P0 + steps))),
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"  {label} decode B={B}, {steps} steps from cache length "
        f"{P0} (max_seq {LM_MAX_SEQ}): {total:.1f} ms "
        f"({r['tokens_per_s']:.0f} tokens/s), p50 {r['p50_ms']:.2f} / p99 "
        f"{r['p99_ms']:.2f} ms a step, bound {r['bound_ms']:.1f} ms "
        f"({r['bound_ms'] / steps:.3f} a step), peak {r['peak_gib']:.2f} GiB")
    return r


def lm_batched_server(model, seed: int) -> dict:
    """Three requests through `BatchedServer` (4 slots) for LM_SERVER_STEPS
    steps, twice: the same tokens both times; p50/p99 ms a step."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import BatchedServer
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist()
               for n in (8, 12, 16)]
    runs = []
    for _ in range(2):
        srv = BatchedServer(model, max_seq=64, batch=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slots = [srv.add_request(p) for p in prompts]
        torch.cuda.synchronize()
        add_ms = (time.perf_counter() - t0) * 1e3
        ms = []
        for _ in range(LM_SERVER_STEPS):
            t0 = time.perf_counter()
            srv.step()                     # ends in a host copy of tokens
            ms.append((time.perf_counter() - t0) * 1e3)
        runs.append(([srv.finish(s) for s in slots], add_ms, sorted(ms)))
        del srv
    if runs[0][0] != runs[1][0]:
        fail("(c) BatchedServer: a second identical session gave other "
             "tokens")
    streams, add_ms, ms = runs[1]
    r = dict(requests=3, steps=LM_SERVER_STEPS, prefill_ms=add_ms,
             p50_ms=percentile(ms, 0.5), p99_ms=percentile(ms, 0.99),
             tokens_per_s=3 * LM_SERVER_STEPS / sum(ms) * 1e3)
    log(f"  (c) BatchedServer, 3 requests (prompts 8, 12, 16 tokens, "
        f"prefilled through {sum(map(len, prompts))} batch decode steps in "
        f"{add_ms:.1f} ms), {LM_SERVER_STEPS} steps: the same tokens twice "
        f"(slot 0 {streams[0][:6]}...); p50 {r['p50_ms']:.2f} / p99 "
        f"{r['p99_ms']:.2f} ms a step, {r['tokens_per_s']:.0f} tokens/s")
    return r


def lm_route_recorder(calls: list):
    """Wrap `moe.route` so each call's (probs, expert ids) is appended to
    `calls` (on the CPU); returns the function to restore."""
    from repro_torch.models import moe
    orig = moe.route

    def route(p, xt, cfg):
        out = orig(p, xt, cfg)
        calls.append((out[0].detach().cpu(), out[2].cpu()))
        return out
    moe.route = route
    return orig


def lm_same_experts(cpu_calls, card_calls, K: int) -> int:
    """Every router call's expert set per token equal on the card and the
    CPU, except where the CPU's k-th and (k+1)-th probabilities are
    within ROUTE_TIE (printed); returns the number of such ties."""
    import torch
    if len(cpu_calls) != len(card_calls):
        fail(f"(d) {len(card_calls)} router calls on the card, "
             f"{len(cpu_calls)} on the CPU")
    ties = 0
    for c, ((pc, ec), (_, eg)) in enumerate(zip(cpu_calls, card_calls)):
        diff = (ec.sort(-1).values != eg.sort(-1).values).any(-1)
        for t in diff.nonzero().flatten().tolist():
            top = torch.topk(pc[t], K + 1).values
            if top[K - 1] - top[K] >= ROUTE_TIE:
                fail(f"(d) router call {c}, token {t}: card experts "
                     f"{sorted(eg[t].tolist())} != CPU "
                     f"{sorted(ec[t].tolist())}")
            ties += 1
            log(f"    (d) router tie at call {c}, token {t}")
    return ties


def lm_split_scan_levels(args, ds) -> dict:
    """split_scan on the inputs that every level of one tree batch of (e)'s
    fit gives it (`capture_exact_levels`): bit-equal to its plain version
    at each level (binary gini), and timed at the deepest level beside its
    plain version and its bound."""
    import torch
    from repro_torch.kernels import split_scan as ss
    levels = capture_exact_levels(args, ds)
    for depth, lv in enumerate(levels):
        ins, kw = lv["ss"]["ins"], lv["ss"]["kw"]
        gk, tk = ss.split_scan(*ins, **kw)
        gp, tp = ss.split_scan_plain(*ins, **kw)
        if not (torch.equal(gk, gp) and torch.equal(tk, tp)):
            fail(f"(e) split_scan on level {depth} of the LM-feature fit: "
                 f"not bit-equal to its plain version")
    ins, kw = levels[-1]["ss"]["ins"], levels[-1]["ss"]["kw"]
    leaf, w, totals = ins[2], ins[3], ins[6]
    (T, n), m = leaf.shape, ins[0].shape[0]
    L1, S = totals.shape[-2], totals.shape[-1]
    act = ((leaf > 0) & (w > 0)).sum().item() * m
    b_ms, b_by = bound_ms(ss.bound_bytes(T, m, n, L1, S), act * 40)
    r = dict(levels=len(levels), T=T, m=m, n=n, L1=L1, max_abs_err=0.0,
             ms=cuda_ms(lambda: ss.split_scan(*ins, **kw)),
             plain_ms=cuda_ms(lambda: ss.split_scan_plain(*ins, **kw),
                              runs=1),
             bound_ms=b_ms, bound_by=b_by)
    log(f"  (e) split_scan bit-equal to its plain version on all "
        f"{len(levels)} levels of one tree batch; deepest "
        f"{json.dumps(r)}")
    return r


def phase11(args, dev) -> dict:
    """LM serving on the card; see the module docstring."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core.dataset import from_numpy
    from repro_torch.core.tree import TreeParams
    from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan
    from repro_torch.models import moe, transformer
    t_phase = time.perf_counter()
    out = {"a": lm_phase_a(args, dev)}

    # (b) qwen3-0.6b at full width, float32, card against CPU
    t0 = time.perf_counter()
    cfg = dc.replace(get_arch("qwen3-0.6b"), dtype="float32")
    params, card, cpu = lm_models(cfg, args.seed, dev)
    n_params = transformer.param_count(card)
    prompts, _ = lm_inputs(cfg, 2, LM_FULL_P, args.seed)
    err, ties = lm_card_vs_cpu(card, cpu, prompts, LM_STEPS, 1e-3,
                               "(b) qwen3-0.6b")
    out["b"] = dict(params=n_params, max_abs_err=err, ties=ties,
                    s=time.perf_counter() - t0)
    log(f"  (b) qwen3-0.6b, {cfg.num_layers} layers, {n_params} params "
        f"(float32, {n_params * 4 / 1e9:.2f} GB): card == CPU over "
        f"prefill B=2 x P={LM_FULL_P} + {LM_STEPS} decode steps (max "
        f"|dlogit| {err:.2e}, ties {ties}), repeat bit-equal; "
        f"{out['b']['s']:.1f} s")
    del card, cpu

    # (c) the same weights in the config's bfloat16, timed
    cfg = get_arch("qwen3-0.6b")
    qwen = transformer.Transformer(cfg, lm_cast(params, cfg), device=dev)
    del params
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"  (c) qwen3-0.6b bfloat16 on {smi}")
    out["c"] = dict(
        prefill=lm_prefill_timing(qwen, *LM_PREFILL, args.seed, "(c)",
                                  args.profile),
        decode=[lm_decode_timing(qwen, b, args.seed, "(c)", args.profile)
                for b in LM_DECODE_BATCHES],
        server=lm_batched_server(qwen, args.seed), card=smi)
    # the serving script as `python -m repro_torch.launch.serve` runs it:
    # its defaults, its own weights drawn from the seed on the card
    from repro_torch.launch import serve
    r = serve.run(cfg, seed=args.seed, device=dev)
    toks = r["tokens"]
    if (tuple(toks.shape) != (4, 16) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size):
        fail(f"(c) launch.serve.run gave tokens of shape "
             f"{tuple(toks.shape)} in [{int(toks.min())}, "
             f"{int(toks.max())}]")
    steps = sorted(r["step_ms"])
    out["c"]["launch_serve"] = dict(
        prefill_s=r["prefill_s"], p50_ms=percentile(steps, 0.5),
        tokens_per_s=toks.shape[0] * len(steps) / r["decode_s"])
    log(f"  (c) launch.serve.run (B=4, P=16, G=16, its own weights): "
        f"prefill {r['prefill_s'] * 1e3:.1f} ms, decode p50 "
        f"{out['c']['launch_serve']['p50_ms']:.2f} ms a step; tokens "
        f"{toks[0][:8].tolist()}...")

    # (d) olmoe-1b-7b at full width, cut to 2 layers
    t0 = time.perf_counter()
    cfg = dc.replace(get_arch("olmoe-1b-7b"), num_layers=2, dtype="float32")
    params, card, cpu = lm_models(cfg, args.seed, dev)
    prompts, _ = lm_inputs(cfg, 2, LM_FULL_P, args.seed)
    calls = []                      # the CPU's, the card's, its repeat's
    orig = lm_route_recorder(calls)
    try:
        err, ties = lm_card_vs_cpu(card, cpu, prompts, LM_STEPS, 1e-3,
                                   "(d) olmoe-1b-7b")
    finally:
        moe.route = orig
    n_calls = len(calls) // 3
    route_ties = lm_same_experts(calls[:n_calls], calls[n_calls:2 * n_calls],
                                 cfg.num_experts_per_tok)
    del card, cpu
    bcfg = dc.replace(cfg, dtype="bfloat16")
    olmoe = transformer.Transformer(bcfg, lm_cast(params, bcfg), device=dev)
    del params
    torch.cuda.empty_cache()
    out["d"] = dict(
        max_abs_err=err, ties=ties, route_ties=route_ties,
        router_calls=n_calls,
        prefill=lm_prefill_timing(olmoe, *LM_PREFILL, args.seed, "(d)",
                                  args.profile),
        decode=lm_decode_timing(olmoe, LM_DECODE_BATCHES[0], args.seed,
                                "(d)", args.profile))
    log(f"  (d) olmoe-1b-7b (d_model {cfg.d_model}, {cfg.num_experts} experts "
        f"top-{cfg.num_experts_per_tok}, {cfg.num_layers} layers): "
        f"card == CPU in float32 (max |dlogit| {err:.2e}, ties {ties}), "
        f"expert ids equal in {n_calls} router calls (ties "
        f"{route_ties}), repeat bit-equal; {time.perf_counter() - t0:.1f} s")
    del olmoe
    torch.cuda.empty_cache()

    # (e) pooled qwen3 features into a forest, as examples/rf_on_embeddings
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    n, S = LM_FEATURE_ROWS, LM_FEATURE_LEN
    toks = rng.integers(0, LM_FEATURE_VOCAB, (n, S)).astype(np.int64)
    pos7 = np.where((toks == 7).any(1), (toks == 7).argmax(1), S + 1)
    pos9 = np.where((toks == 9).any(1), (toks == 9).argmax(1), S + 1)
    y = (pos7 < pos9).astype(np.int32)
    feats = []
    for i in range(0, n, LM_FEATURE_CHUNK):
        x, _, _ = qwen.forward_hidden(
            torch.from_numpy(toks[i:i + LM_FEATURE_CHUNK]).to(dev))
        feats.append(x.float().mean(dim=1))
    feats = torch.cat(feats).cpu().numpy()
    embed_s = time.perf_counter() - t0
    if not np.isfinite(feats).all() or feats.shape != (n, qwen.cfg.d_model):
        fail(f"(e) features: shape {feats.shape} or non-finite values")
    del qwen
    torch.cuda.empty_cache()
    cut = 3 * n // 4
    train = from_numpy(feats[:cut], None, y[:cut])
    test = from_numpy(feats[cut:], None, y[cut:])
    rf, fit = run_fit(args, train, TreeParams(max_depth=10,
                                              backend="kernel"),
                      {"split_scan": split_scan}, "(e) LM-feature forest",
                      idle={"cat_hist": cat_hist, "feat_hist": feat_hist,
                            "breiman": breiman})
    auc = rf.auc(test)
    out["e"] = dict(rows=n, seq=S, embed_s=embed_s, auc=auc,
                    positives=float(y.mean()),
                    split_scan=lm_split_scan_levels(args, train), **fit)
    log(f"  (e) {n} sequences x {S} tokens embedded in {embed_s:.2f} s "
        f"(bfloat16 forward_hidden, mean-pooled to float32, "
        f"{feats.shape[1]} features, {y.mean():.3f} positive); forest on "
        f"{cut} rows: split_scan launched {fit['launches']['split_scan']} "
        f"times, repeat grew identical trees, held-out AUC {auc:.4f}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 11 total {out['phase_s']:.1f} s")
    log(f"  phase 11 {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: LM training on the card
# ---------------------------------------------------------------------------

def lm_train_clone(state, tcfg, device):
    """A copy of a train state on `device` (weights, moments, step)."""
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    copy = lambda t: t.detach().to(device, copy=True)
    model = state["model"]
    clone = transformer.Transformer(
        model.cfg, adamw.map_tree(copy, model.params.tree()), device=device)
    opt = {"mu": adamw.map_tree(copy, state["opt"]["mu"]),
           "nu": adamw.map_tree(copy, state["opt"]["nu"]),
           "step": copy(state["opt"]["step"])}
    return tstep.train_state(clone, tcfg, opt)


def lm_train_init(cfg, tcfg, seed: int, dev):
    """`cfg`'s weights drawn from `seed` on the card and zero moments: the
    train state on the card and its copy on the host."""
    from repro_torch.train import step as tstep
    card = tstep.init_train_state(seed, cfg, tcfg, device=dev)
    return card, lm_train_clone(card, tcfg, "cpu")


def lm_train_batch(cfg, B: int, S: int, seed: int) -> dict:
    """One batch on the CPU: the `TokenStream` (token models), or float32
    embeddings and token labels drawn with numpy (the stub frontends)."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.train import to_batch
    if cfg.input_mode == "tokens":
        return to_batch(next(TokenStream(cfg.vocab_size, S, B, seed)), "cpu")
    rng = np.random.default_rng(seed)
    return {"inputs": torch.from_numpy(
                rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)),
            "labels": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))}


def lm_train_step(step_fn, state, batch, dev):
    """One step on `dev` ending in a sync; returns (state, metrics as
    floats, host ms)."""
    import torch
    batch = {k: v.to(dev) for k, v in batch.items()}
    t0 = time.perf_counter()
    state, m = step_fn(state, batch)
    m = {k: float(v) for k, v in m.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state, m, (time.perf_counter() - t0) * 1e3


LM_TRAIN_CHECK_OPT = dict(lr=1e-3, warmup_steps=1)   # card == CPU steps


def lm_train_update_tolerance(ocfg, t: int, lr: float, want, got, p_new):
    """How far one side's step-`t` AdamW update of a leaf may lie from
    the other's, element by element, from the same parameters.  `want`,
    `got`: each side's (mu, nu) after the step, float64 on one device.
    With r = m̂/(√v̂ + eps) the update is lr·(r + wd·p_old), and the gap
    is bounded exactly by lr·(|m̂ − m̂'|/(√v̂' + eps)
    + |m̂|·|1/(√v̂ + eps) − 1/(√v̂' + eps)|) from the two sides' own
    moments, plus float32 rounding (1e-6 of the update and one ulp of
    the parameter on each side).  ~1e-6 of lr where the moments agree;
    it opens up only where a gradient element lies within the two sides'
    rounding of zero, so that the direction of its step is noise."""
    import torch
    c1, c2 = 1 - ocfg.b1 ** t, 1 - ocfg.b2 ** t
    mw, mg = want[0] / c1, got[0] / c1
    aw = torch.sqrt(want[1] / c2) + ocfg.eps
    ag = torch.sqrt(got[1] / c2) + ocfg.eps
    gap = (mw - mg).abs() / ag + mw.abs() * (1 / aw - 1 / ag).abs()
    return (lr * (gap + 1e-6 * (1 + (mw / aw).abs()))
            + 2 * torch.finfo(p_new.dtype).eps * p_new.double().abs())


def lm_train_card_vs_cpu(before, card, cpu, m_card, m_cpu, moment_tol,
                         tcfg, label):
    """After one step on the card and on the CPU from the same state
    (`before`: its parameters by flat key, on the card): metrics within
    rtol 1e-4; each parameter element's update p_new − p_old within
    `lm_train_update_tolerance` of the CPU's (the elements whose
    tolerance passes lr/2, their step's direction unpinned, are
    counted); each moment leaf within rtol 1e-4 and atol `moment_tol` of
    its largest magnitude.  Compared on the card, one leaf at a time.
    Returns the worst errors seen: metrics relative, the largest update
    gap over its tolerance (at most 1), moments relative to scale; the
    share of parameter elements whose tolerance is below 1e-3·lr, and
    the unpinned count."""
    import torch
    from repro_torch.checkpoint import io
    worst = {"metrics": 0.0, "update": 0.0, "moments": 0.0, "tight": 0,
             "unpinned": 0}
    n_params = 0
    for k, w in m_cpu.items():
        err = abs(m_card[k] - w)
        worst["metrics"] = max(worst["metrics"], err / max(abs(w), 1e-30))
        if err > 1e-4 * abs(w) + 1e-7:
            fail(f"{label}: {k} {m_card[k]!r} on the card, {w!r} on the CPU")
    lr, t = m_cpu["lr"], int(cpu["opt"]["step"])
    a, b = io.flatten_state(card), io.flatten_state(cpu)
    dev = a["opt/step"].device
    for key, want in b.items():
        got = a[key]
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{label}: {key} {got.dtype} {tuple(got.shape)} on the "
                 f"card, {want.dtype} {tuple(want.shape)} on the CPU")
        if key == "opt/step":
            if not torch.equal(got.cpu(), want):
                fail(f"{label}: step {int(got)} != {int(want)}")
            continue
        want = want.to(dev)
        if key.startswith("opt/"):
            got, want = got.float(), want.float()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            worst["moments"] = max(worst["moments"],
                                   err / max(scale, 1e-30))
            if not torch.allclose(got, want, rtol=1e-4,
                                  atol=moment_tol * scale):
                fail(f"{label}: {key} differs on the card by up to "
                     f"{err:.3e} (largest magnitude {scale:.3e})")
            continue
        name = key[len("params/"):]
        mom = lambda side: tuple(side[f"opt/{m}/{name}"].to(dev).double()
                                 for m in ("mu", "nu"))
        tol = lm_train_update_tolerance(tcfg.optimizer, t, lr, mom(b),
                                        mom(a), want)
        p0 = before[key].double()
        gap = ((got.double() - p0) - (want.double() - p0)).abs()
        n_bad = int((gap > tol).sum())
        worst["update"] = max(worst["update"], float((gap / tol).max()))
        worst["tight"] += int((tol < 1e-3 * lr).sum())
        worst["unpinned"] += int((tol > lr / 2).sum())
        n_params += tol.numel()
        if n_bad:
            fail(f"{label}: {key}: {n_bad} updates on the card off the "
                 f"CPU's, the worst by {float(gap.max()):.3e} (lr "
                 f"{lr:.3e})")
        del tol, gap, p0
    worst["tight"] /= n_params
    return worst


def lm_train_checked_step(step_fn, card, cpu, batch, dev, moment_tol, tcfg,
                          label):
    """One step of `step_fn` on the CPU and on the card from the same
    state, held by `lm_train_card_vs_cpu`.  Returns (card state, cpu
    state, card metrics, the worst errors, CPU step ms, card step ms)."""
    import torch
    from repro_torch.checkpoint import io
    before = {k: v.clone() for k, v in io.flatten_state(card).items()
              if k.startswith("params/")}
    cpu, m_cpu, cpu_ms = lm_train_step(step_fn, cpu, batch,
                                       torch.device("cpu"))
    card, m_card, card_ms = lm_train_step(step_fn, card, batch, dev)
    worst = lm_train_card_vs_cpu(before, card, cpu, m_card, m_cpu,
                                 moment_tol, tcfg, label)
    return card, cpu, m_card, worst, cpu_ms, card_ms


def lm_train_worst(w) -> str:
    return (f"worst: metrics {w['metrics']:.1e}, update gap "
            f"{w['update']:.2f} of its tolerance ({100 * w['tight']:.4f}% of "
            f"elements held within 1e-3 of lr, {w['unpinned']} unpinned), "
            f"moments {w['moments']:.1e} of scale")


def lm_train_same_bits(a, b, m_a, m_b, label) -> None:
    """Two runs of the same steps on the card: equal metrics and every
    parameter and moment bit for bit."""
    import torch
    from repro_torch.checkpoint import io
    if m_a != m_b:
        fail(f"{label}: a repeat on the card gave other metrics: "
             f"{m_a} != {m_b}")
    la, lb = io.flatten_state(a), io.flatten_state(b)
    for key, t in la.items():
        if not torch.equal(t, lb[key]):
            fail(f"{label}: a repeat on the card gave another {key}")


def lm_train_bound_ms(model, B: int, S: int) -> tuple[float, float]:
    """(bound ms, FLOP) of one train step with full remat: every block
    product 4 times (forward, the recompute, 2 in backward: 8·params·T),
    the head 4 times (the chunked CE recomputes it), the causal attention
    products 4 times, over the dtype's peak; against the parameters and
    float32 moments read and written once over 3.35 TB/s."""
    from repro_torch.models import transformer
    cfg, c = model.cfg, lm_counts(model)
    T = B * S
    win = cfg.sliding_window or S
    keys = sum(min(t + 1, win) for t in range(S))
    flops = (8 * (c["blocks"] + c["head"]) * T
             + 4 * c["attn_layers"] * 4 * B * cfg.num_heads * cfg.hd * keys)
    n = transformer.param_count(model)
    nbytes = n * (2 * c["eb"] + 2 * 2 * 4)
    peak = BF16_FLOP_PER_S if cfg.dtype == "bfloat16" else FP32_FLOP_PER_S
    return max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3, flops


def lm_train_timing(state, step_fn, batches, dev, label,
                    profile: bool = False) -> dict:
    """Steps over `batches` (each ending in a sync), the first a warm-up:
    p50/p99 host ms of the others, tokens/s at p50, the bound, peak
    memory; with `profile` one more step under the profiler."""
    import numpy as np
    import torch
    cfg = state["model"].cfg
    B, S = batches[0]["labels"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, ces = [], []
    for batch in batches:
        state, m, t = lm_train_step(step_fn, state, batch, dev)
        ms.append(t)
        ces.append(m["ce"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = sorted(ms[1:])
    bound, flops = lm_train_bound_ms(state["model"], B, S)
    r = dict(B=B, S=S, steps=len(ms), first_ms=ms[0],
             p50_ms=percentile(steady, 0.5), p99_ms=percentile(steady, 0.99),
             bound_ms=bound, tflop=flops / 1e12, peak_gib=peak, ce=ces)
    r["tokens_per_s"] = B * S / r["p50_ms"] * 1e3
    if not np.isfinite(ces).all():
        fail(f"{label}: non-finite ce {ces}")
    log(f"  {label} {cfg.name} ({cfg.dtype}) B={B} x S={S}: first step "
        f"{ms[0]:.1f} ms, then p50 {r['p50_ms']:.1f} / p99 "
        f"{r['p99_ms']:.1f} ms a step ({r['tokens_per_s']:.0f} tokens/s), "
        f"bound {bound:.2f} ms ({r['tflop']:.2f} TFLOP), peak "
        f"{peak:.2f} GiB; ce {ces[0]:.4f} -> {ces[-1]:.4f}")
    if profile:
        batch = {k: v.to(dev) for k, v in batches[-1].items()}
        profiled(lambda: step_fn(state, batch), r["p50_ms"] / 1e3)
    return r


def lm_train_archs(args, dev) -> dict:
    """(a): every registered architecture's reduced variant (float32), one
    step on the card against the CPU's from the same state, a repeat on
    the card bit-equal; the steps' deterministic-algorithm alerts
    counted under warn_only (a census: the fatal check is the repeat)."""
    import warnings
    import torch
    from repro_torch.configs.base import get_arch, list_archs
    from repro_torch.train import step as tstep
    from repro_torch.optim import adamw
    out, alerts = {}, {}
    tcfg = tstep.TrainConfig(ce_chunks=4, optimizer=adamw.AdamWConfig(
        **LM_TRAIN_CHECK_OPT))
    for i, arch in enumerate(list_archs()):
        t0 = time.perf_counter()
        cfg = get_arch(arch).reduced()
        step_fn = tstep.make_train_step(cfg, tcfg)
        card, cpu = lm_train_init(cfg, tcfg, args.seed + i, dev)
        again = lm_train_clone(card, tcfg, dev)
        census = lm_train_clone(card, tcfg, dev)
        batch = lm_train_batch(cfg, *LM_TRAIN_SMALL, args.seed + i)
        card, cpu, m_card, worst, cpu_ms, card_ms = lm_train_checked_step(
            step_fn, card, cpu, batch, dev, 1e-4, tcfg, f"(a) {arch}")
        again, m_again, again_ms = lm_train_step(step_fn, again, batch, dev)
        lm_train_same_bits(card, again, m_card, m_again, f"(a) {arch}")
        before = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                lm_train_step(step_fn, census, batch, dev)
            finally:
                torch.use_deterministic_algorithms(before[0],
                                                   warn_only=before[1])
        for w in caught:
            msg = str(w.message).split(".")[0][:90]
            alerts[msg] = alerts.get(msg, 0) + 1
        out[arch] = dict(worst=worst, cpu_ms=cpu_ms, card_ms=card_ms,
                         repeat_ms=again_ms, s=time.perf_counter() - t0)
        log(f"  (a) {arch}: one step card == CPU ({lm_train_worst(worst)}), "
            f"repeat bit-equal; card {card_ms:.0f} / {again_ms:.0f} ms, CPU {cpu_ms:.0f} ms; {out[arch]['s']:.1f} s")
        del card, cpu, again, census
    log(f"  (a) deterministic-algorithm alerts over the 11 steps: "
        f"{json.dumps(alerts)}")
    out["alerts"] = alerts
    return out


def phase12(args, dev) -> dict:
    """LM training on the card; see the module docstring."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.checkpoint import io
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    t_phase = time.perf_counter()
    kernels = {"split_scan": split_scan, "cat_hist": cat_hist,
               "feat_hist": feat_hist, "breiman": breiman}
    for mod in kernels.values():
        mod.launches = 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"  on {smi}")
    out = {"card": smi, "a": lm_train_archs(args, dev)}

    # (b) the ~100M config of examples/train_lm.py --hundred-m
    t0 = time.perf_counter()
    cfg = dc.replace(get_arch("qwen3-0.6b"), num_layers=12, d_model=768,
                     d_ff=2048, num_heads=12, num_kv_heads=4, head_dim=64,
                     vocab_size=32768, dtype="float32")
    tcfg = tstep.TrainConfig(ce_chunks=4, optimizer=adamw.AdamWConfig(
        **LM_TRAIN_CHECK_OPT))
    card, cpu = lm_train_init(cfg, tcfg, args.seed, dev)
    batch = lm_train_batch(cfg, *LM_TRAIN_CHECK, args.seed)
    card, cpu, _, worst_b, cpu_ms, _ = lm_train_checked_step(
        tstep.make_train_step(cfg, tcfg), card, cpu, batch, dev, 1e-3, tcfg,
        "(b) 100M")
    del card, cpu
    log(f"  (b) {cfg.num_layers} x {cfg.d_model}, vocab {cfg.vocab_size}: "
        f"one step at B={LM_TRAIN_CHECK[0]} x S={LM_TRAIN_CHECK[1]} card == "
        f"CPU ({lm_train_worst(worst_b)}); CPU step {cpu_ms:.0f} ms; "
        f"{time.perf_counter() - t0:.1f} s")
    step_ms = []
    make = tstep.make_train_step

    def timed_make(*a, **k):        # launch.train's step, each call timed
        fn = make(*a, **k)

        def timed(state, batch):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            return state, m
        return timed
    B, S = LM_TRAIN_100M
    torch.cuda.reset_peak_memory_stats()
    launch_train.train_step_lib.make_train_step = timed_make
    try:
        state_b, losses = launch_train.train_loop(
            cfg, steps=LM_TRAIN_100M_STEPS, batch=B, seq=S, lr=1e-3,
            seed=args.seed, log_every=50, ce_chunks=4, device=dev)
    finally:
        launch_train.train_step_lib.make_train_step = make
    peak = torch.cuda.max_memory_allocated() / 2**30
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first:
        fail(f"(b) the loss did not fall: ce first10 {first:.4f}, last10 "
             f"{last:.4f}")
    steady = sorted(step_ms[1:])
    bound, flops = lm_train_bound_ms(state_b["model"], B, S)
    out["b"] = dict(worst=worst_b, steps=len(step_ms), first_ms=step_ms[0],
                    p50_ms=percentile(steady, 0.5),
                    p99_ms=percentile(steady, 0.99), bound_ms=bound,
                    tflop=flops / 1e12, peak_gib=peak, ce_first10=first,
                    ce_last10=last, s=time.perf_counter() - t0)
    out["b"]["tokens_per_s"] = B * S / out["b"]["p50_ms"] * 1e3
    log(f"  (b) launch.train.train_loop {LM_TRAIN_100M_STEPS} steps at "
        f"B={B} x S={S}, lr 1e-3: ce first10 {first:.4f} -> last10 "
        f"{last:.4f}; first step {step_ms[0]:.1f} ms, then p50 "
        f"{out['b']['p50_ms']:.1f} / p99 {out['b']['p99_ms']:.1f} ms a step "
        f"({out['b']['tokens_per_s']:.0f} tokens/s), bound {bound:.2f} ms "
        f"({flops / 1e12:.2f} TFLOP, float32), peak {peak:.2f} GiB; "
        f"{out['b']['s']:.1f} s")

    # (e) train-state checkpoints written and restored on the card
    ckdir = ROOT / "build" / "repro_torch" / "lm_train"
    try:
        path = str(ckdir / "state_100m.npz")
        io.save_state(path, state_b)
        back = io.restore_state(path, cfg, tcfg, device=dev)
        lm_train_same_bits(state_b, back, {}, {}, "(e) 100M checkpoint")
        small = dc.replace(get_arch("qwen3-0.6b").reduced(), dtype="bfloat16")
        stcfg = tstep.TrainConfig(ce_chunks=4, optimizer=adamw.AdamWConfig(
            moments_dtype="bfloat16"))
        st, _ = lm_train_init(small, stcfg, args.seed, dev)
        st, _, _ = lm_train_step(tstep.make_train_step(small, stcfg), st,
                                 lm_train_batch(small, *LM_TRAIN_SMALL,
                                                args.seed), dev)
        path = str(ckdir / "state_bf16.npz")
        io.save_state(path, st)
        back = io.restore_state(path, small, stcfg, device=dev)
        lm_train_same_bits(st, back, {}, {}, "(e) bfloat16 checkpoint")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log("  (e) train-state checkpoints (the 100M float32 state after "
        f"{LM_TRAIN_100M_STEPS} steps; a bfloat16 state with bfloat16 "
        "moments) written and restored on the card bit for bit")
    del state_b, back, st
    torch.cuda.empty_cache()

    # (c) qwen3-0.6b at full width: one float32 step card == CPU, then
    # bfloat16 steps timed
    t0 = time.perf_counter()
    cfg = dc.replace(get_arch("qwen3-0.6b"), dtype="float32")
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(
        **LM_TRAIN_CHECK_OPT))
    card, cpu = lm_train_init(cfg, tcfg, args.seed, dev)
    batch = lm_train_batch(cfg, *LM_TRAIN_CHECK, args.seed)
    init_s = time.perf_counter() - t0
    card, cpu, _, worst_c, cpu_ms, _ = lm_train_checked_step(
        tstep.make_train_step(cfg, tcfg), card, cpu, batch, dev, 1e-3, tcfg,
        "(c) qwen3-0.6b float32")
    log(f"  (c) qwen3-0.6b float32, {cfg.num_layers} layers: one step at "
        f"B={LM_TRAIN_CHECK[0]} x S={LM_TRAIN_CHECK[1]} card == CPU "
        f"({lm_train_worst(worst_c)}); init and host copy {init_s:.1f} s, "
        f"CPU step {cpu_ms:.0f} ms; {time.perf_counter() - t0:.1f} s")
    del card, cpu
    torch.cuda.empty_cache()
    cfg = get_arch("qwen3-0.6b")
    tcfg = tstep.TrainConfig()
    B, S = LM_TRAIN_FULL
    stream = TokenStream(cfg.vocab_size, S, B, args.seed)
    batches = [launch_train.to_batch(next(stream), "cpu")
               for _ in range(LM_TRAIN_FULL_STEPS)]
    step_fn = tstep.make_train_step(cfg, tcfg)
    state = tstep.init_train_state(args.seed, cfg, tcfg, device=dev)
    out["c"] = dict(worst=worst_c, **lm_train_timing(
        state, step_fn, batches, dev, "(c)", args.profile))
    del state
    torch.cuda.empty_cache()

    # (f) two identical runs of 3 steps: the same bits
    runs = []
    for _ in range(2):
        st = tstep.init_train_state(args.seed, cfg, tcfg, device=dev)
        ms = []
        for batch in batches[:LM_TRAIN_REPEAT_STEPS]:
            st, m, _ = lm_train_step(step_fn, st, batch, dev)
            ms.append(m)
        runs.append((st, ms))
    lm_train_same_bits(runs[0][0], runs[1][0], runs[0][1], runs[1][1],
                       "(f) qwen3-0.6b bfloat16")
    out["f"] = dict(ce=[m["ce"] for m in runs[0][1]])
    log(f"  (f) two runs of {LM_TRAIN_REPEAT_STEPS} bfloat16 steps of "
        f"qwen3-0.6b at B={B} x S={S}: every metric and every parameter "
        f"and moment bit-equal (ce {out['f']['ce']})")
    del runs, st
    torch.cuda.empty_cache()

    # (d) olmoe-1b-7b at full width, 2 layers
    t0 = time.perf_counter()
    cfg = dc.replace(get_arch("olmoe-1b-7b"), num_layers=2, dtype="float32")
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(
        **LM_TRAIN_CHECK_OPT))
    card, cpu = lm_train_init(cfg, tcfg, args.seed, dev)
    again = lm_train_clone(card, tcfg, dev)
    step_fn = tstep.make_train_step(cfg, tcfg)
    batch = lm_train_batch(cfg, *LM_TRAIN_CHECK, args.seed)
    calls = []                      # the CPU's, the card's
    orig = lm_route_recorder(calls)
    try:
        card, cpu, m_card, worst_d, cpu_ms, _ = lm_train_checked_step(
            step_fn, card, cpu, batch, dev, 1e-3, tcfg,
            "(d) olmoe-1b-7b float32")
    finally:
        moe.route = orig
    n_calls = len(calls) // 2
    route_ties = lm_same_experts(calls[:n_calls], calls[n_calls:],
                                 cfg.num_experts_per_tok)
    again, m_again, _ = lm_train_step(step_fn, again, batch, dev)
    lm_train_same_bits(card, again, m_card, m_again, "(d) olmoe-1b-7b")
    log(f"  (d) olmoe-1b-7b float32 ({cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok}, {cfg.num_layers} layers): one step "
        f"card == CPU ({lm_train_worst(worst_d)}), expert ids equal in "
        f"{n_calls} router calls (ties {route_ties}), repeat bit-equal; CPU "
        f"step {cpu_ms:.0f} ms; {time.perf_counter() - t0:.1f} s")
    del card, cpu, again
    torch.cuda.empty_cache()
    bcfg = dc.replace(cfg, dtype="bfloat16")
    tcfg = tstep.TrainConfig()
    B, S = LM_TRAIN_FULL
    stream = TokenStream(bcfg.vocab_size, S, B, args.seed)
    batches = [launch_train.to_batch(next(stream), "cpu")
               for _ in range(LM_TRAIN_MOE_STEPS)]
    state = tstep.init_train_state(args.seed, bcfg, tcfg, device=dev)
    out["d"] = dict(worst=worst_d, router_calls=n_calls,
                    route_ties=route_ties, **lm_train_timing(
                        state, tstep.make_train_step(bcfg, tcfg), batches,
                        dev, "(d)", args.profile))
    del state
    torch.cuda.empty_cache()

    launches = {name: mod.launches for name, mod in kernels.items()}
    if any(launches.values()):
        fail(f"phase 12 launched a kernel off its path: {launches}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  no kernel launched in phase 12 ({json.dumps(launches)}); "
        f"phase 12 total {out['phase_s']:.1f} s")
    log(f"  phase 12 {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the legacy closures, sharded LM training, the dry run
# ---------------------------------------------------------------------------

def legacy_fits(args, dev, leo, maj) -> dict:
    """Phase 13 (a): `fit(ds, supersplit_fn=closure)` on the card, both
    signatures, against the engine fits of the same forests."""
    import warnings
    import torch
    from repro_torch.core import splits
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.forest import RandomForest
    from repro_torch.core.level.plan import _leaf_totals
    from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan
    from repro_torch.kernels import ops as kops
    kernels = {"split_scan": split_scan, "cat_hist": cat_hist,
               "feat_hist": feat_hist, "breiman": breiman}
    out = {}
    seen = {}

    def sorted_fn(sv, si, leaf_of, w, stats, cand, Lp, impurity, task,
                  min_records):
        """The kernel scorer, one tree: the level's totals from this
        tree's rows, its (1, ...) tree axis put on and taken off."""
        totals = _leaf_totals(leaf_of[None], stats[None], w[None], Lp, task)
        call = (sv, si, leaf_of[None], w[None], labels, cand[None], totals,
                impurity, task, min_records)
        seen["split_scan"] = call
        g, t = kops.split_scan_supersplit(*call)
        return g[0], t[0]

    def hist_fn(bin_of, bin_edges, leaf_of, w, stats, cand, Lp, impurity,
                task, min_records):
        """feat_hist tables of this tree's leaves, the bucket scorer, and
        the winning bucket's float edge as the threshold."""
        call = dict(x=bin_of, slot=leaf_of[None], w=w[None], y=labels,
                    W=Lp + 1, B=bin_edges.shape[1])
        seen["feat_hist"] = call
        tables = kops.feature_tables(bin_of, leaf_of[None], w[None], labels,
                                     B=bin_edges.shape[1], W=Lp + 1)
        g, cut = splits.best_numeric_split_histogram(
            tables[0], cand, impurity, task, min_records)
        return g, torch.gather(bin_edges, 1, cut.long())

    adapter = kops.categorical_tables

    def cat_record(cat_cols, leaf_of, w, labels_, **kw):
        seen["cat_hist"] = dict(x=cat_cols, leaf=leaf_of, w=w, y=labels_,
                                **kw)
        return adapter(cat_cols, leaf_of, w, labels_, **kw)

    for label, ds, params, fn in (
            ("sorted", leo, dataclasses.replace(exact_params(args),
                                                max_depth=LEGACY_DEPTH),
             sorted_fn),
            ("hist", maj, dataclasses.replace(hist_params(args),
                                              max_depth=LEGACY_DEPTH),
             hist_fn)):
        labels = torch.as_tensor(ds.labels, device=dev)
        t0 = time.perf_counter()
        plain = RandomForest(params, num_trees=LEGACY_TREES, seed=args.seed,
                             tree_batch=LEGACY_TREES).fit(ds)
        plain_s = time.perf_counter() - t0
        for mod in kernels.values():
            mod.launches = 0
        batch0, steps0 = tree_lib._BATCH_STEP_CALLS[0], tree_lib._STEP_CALLS[0]
        kops.categorical_tables = cat_record
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rf = RandomForest(params, num_trees=LEGACY_TREES,
                                  seed=args.seed).fit(ds, supersplit_fn=fn)
                torch.cuda.synchronize()
                legacy_s = time.perf_counter() - t0
        finally:
            kops.categorical_tables = adapter
        launches = {k: m.launches for k, m in kernels.items()}
        steps = tree_lib._STEP_CALLS[0] - steps0
        if not any("per-tree builder" in str(w.message) for w in caught):
            fail(f"13 (a) {label}: no per-tree builder warning")
        if tree_lib._BATCH_STEP_CALLS[0] != batch0 or steps <= 0:
            fail(f"13 (a) {label}: {tree_lib._BATCH_STEP_CALLS[0] - batch0} "
                 f"batched steps, {steps} per-tree steps")
        a, b = tree_digest(plain.trees), tree_digest(rf.trees)
        if a != b:
            fail(f"13 (a) {label}: closure trees {b} != engine trees {a}")
        want = ("split_scan", "cat_hist", "breiman") if label == "sorted" \
            else ("feat_hist",)
        if any(launches[k] <= 0 for k in want):
            fail(f"13 (a) {label}: a kernel of the path never launched: "
                 f"{launches}")
        out[label] = dict(launches=launches, steps=steps, sha256=b,
                          legacy_s=legacy_s, engine_s=plain_s)
        log(f"  (a) {label} closure fit of {LEGACY_TREES} trees, depth "
            f"{LEGACY_DEPTH}, n={ds.n}: warned, {steps} per-tree steps, "
            f"no batched step, launches {json.dumps(launches)}; trees == "
            f"the engine fit's (sha256 {b[:16]}); {legacy_s:.2f} s against "
            f"the batched engine fit's {plain_s:.2f} s")
    # one captured call of each kernel against its plain twin, bit-equal
    before = {k: m.launches for k, m in kernels.items()}
    c = seen["split_scan"]
    args_ = (c[0].contiguous(), c[1].contiguous(), c[2].contiguous(),
             c[3].contiguous(), c[4].to(torch.float32).contiguous(),
             c[5].contiguous(), c[6].contiguous())
    kw = dict(impurity=c[7], task=c[8], min_records=c[9])
    pairs = {"split_scan": (split_scan.split_scan(*args_, **kw),
                            split_scan.split_scan_plain(*args_, **kw))}
    c = seen["cat_hist"]
    ca = (c["x"].contiguous(), c["leaf"].contiguous(), c["w"].contiguous(),
          c["y"].to(torch.float32).contiguous())
    ckw = dict(L1=c["Lp"] + 1, V=c["V"],
               num_stats=kops.stat_dim(c.get("num_classes", 2),
                                       c.get("task", "classification")))
    pairs["cat_hist"] = (cat_hist.cat_hist(*ca, **ckw),
                         cat_hist.cat_hist_plain(*ca, **ckw))
    c = seen["feat_hist"]
    fa = (c["x"].contiguous(), c["slot"].to(torch.int32).contiguous(),
          c["w"].contiguous(), c["y"].to(torch.float32).contiguous())
    fkw = dict(W=c["W"], B=c["B"], num_stats=2)
    pairs["feat_hist"] = (feat_hist.feat_hist(*fa, **fkw),
                          feat_hist.feat_hist_plain(*fa, **fkw))
    for name, (k, p) in pairs.items():
        k = k if isinstance(k, tuple) else (k,)
        p = p if isinstance(p, tuple) else (p,)
        if not all(torch.equal(x, y) for x, y in zip(k, p)):
            fail(f"13 (a): {name} on the last captured closure call differs "
                 f"from its plain version")
    for name, mod in kernels.items():     # the checks' own launches
        mod.launches = before[name]
    log("  (a) the last captured split_scan, cat_hist and feat_hist calls of "
        "the closure fits: each kernel bit-equal to its plain version")
    return out


def lm_mesh_probe(dev) -> dict:
    """gloo's eager collectives on CUDA tensors over the default group:
    "ok" or the error of each."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size()
    x = torch.ones(n, 3, device=dev)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(n * n, 3, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(1, 3, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def lm_mesh_init(cfg, tcfg, seed: int, dev, mesh):
    """The train state of `cfg` drawn from `seed` on the card and sharded
    on `mesh`; the ranks draw one at a time, so that one full state at
    most lies on the card beside the shards."""
    import torch
    import torch.distributed as dist
    from repro_torch.train import step as tstep
    state = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            state = tstep.shard_state(
                tstep.init_train_state(seed, cfg, tcfg, device=dev), mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    return state


def lm_mesh_step(step_fn, state, batch, mesh, dev):
    """One sharded step ending in a sync: (state, metrics as floats, ms)."""
    import torch
    from repro_torch.train import sharding as shd
    from repro_torch.train import step as tstep
    rules = shd.make_rules(mesh)
    b = {k: shd.distribute(v.to(dev), mesh, shd.placements(
        shd.logical_spec(("batch", "seq"), mesh, rules, v.shape), mesh))
        for k, v in batch.items()}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with shd.use_mesh_rules(mesh):
        state, m = step_fn(state, b)
    m = {k: tstep.scalar(v) for k, v in m.items()}
    sync()
    return state, m, (time.perf_counter() - t0) * 1e3


def lm_mesh_worker(args) -> int:
    """One rank of phase 13 (b); prints one `LM-MESH-RESULT {json}`."""
    import dataclasses as dc
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    rank, world, store = (int(args.lm_mesh_worker[0]),
                          int(args.lm_mesh_worker[1]), args.lm_mesh_worker[2])
    dev = torch.device(LM_MESH_DEVICE, 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    kernels = {"split_scan": split_scan, "cat_hist": cat_hist,
               "feat_hist": feat_hist, "breiman": breiman}
    for mod in kernels.values():
        mod.launches = 0
    out = {"rank": rank, "gloo_cuda": lm_mesh_probe(dev)}
    refused = {k: v for k, v in out["gloo_cuda"].items() if v != "ok"}
    if refused:
        fail(f"13 (b): gloo refuses on CUDA tensors: {refused}")
    mesh_lib.eager_collectives("CUDA")
    mesh = mesh_lib.make_host_mesh(*LM_MESH_SHAPE, device_type=dev.type)
    cpu_mesh = mesh_lib.make_host_mesh(*LM_MESH_SHAPE, device_type="cpu")
    me = rank == 0

    # float32 qwen3-0.6b: a sharded step == the one-device card step, and a
    # repeat of the sharded step bit-equal, each held shard by shard on
    # its own rank (no state is gathered)
    t0 = time.perf_counter()
    cfg = dc.replace(get_arch("qwen3-0.6b"), dtype="float32")
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(
        **LM_TRAIN_CHECK_OPT))
    step_fn = tstep.make_train_step(cfg, tcfg)
    batch = lm_train_batch(cfg, *LM_MESH_CHECK, args.seed)
    runs = []
    for _ in range(2):
        st = lm_mesh_init(cfg, tcfg, args.seed, dev, mesh)
        st, m, _ = lm_mesh_step(step_fn, st, batch, mesh, dev)
        runs.append((lm_mesh_shards(st, tcfg), m))
        del st
        torch.cuda.empty_cache()
    lm_train_same_bits(runs[0][0], runs[1][0], runs[0][1], runs[1][1],
                       "13 (b) qwen3-0.6b float32 sharded, repeat")
    shards, m = runs[0]
    del runs
    one_shards = before = m_one = None
    for r in range(world):          # the one-device step, one rank at a time
        if r == rank:
            one = tstep.init_train_state(args.seed, cfg, tcfg, device=dev)
            before = {k: v for k, v in io_flat(lm_mesh_shards(
                tstep.shard_state(one, mesh), tcfg)).items()
                if k.startswith("params/")}
            one, m_one, _ = lm_train_step(step_fn, one, batch, dev)
            one_shards = lm_train_clone(lm_mesh_shards(
                tstep.shard_state(one, mesh), tcfg), tcfg, "cpu")
            del one
            torch.cuda.empty_cache()
        dist.barrier()
    worst = lm_train_card_vs_cpu(before, shards, one_shards, m, m_one, 1e-3,
                                 tcfg, "13 (b) qwen3-0.6b float32 sharded")
    out["f32"] = dict(worst=worst, s=time.perf_counter() - t0)
    del shards, one_shards, before
    torch.cuda.empty_cache()
    dist.barrier()

    # bfloat16 qwen3-0.6b at B = 4 x 2048, remat full: timed steps
    cfg = get_arch("qwen3-0.6b")
    tcfg = tstep.TrainConfig()
    step_fn = tstep.make_train_step(cfg, tcfg)
    B, S = LM_TRAIN_FULL
    stream = TokenStream(cfg.vocab_size, S, B, args.seed)
    batches = [launch_train.to_batch(next(stream), "cpu")
               for _ in range(LM_MESH_STEPS + 1)]
    st = lm_mesh_init(cfg, tcfg, args.seed, dev, mesh)
    torch.cuda.reset_peak_memory_stats()
    ms, ces = [], []
    for i, batch in enumerate(batches):
        if i == 1:
            mesh_lib.COLLECTIVE_LOG.clear()
        st, m, t = lm_mesh_step(step_fn, st, batch, mesh, dev)
        ms.append(t)
        ces.append(m["ce"])
    by_axis = mesh_lib.collective_bytes_by_axis(mesh)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with roofline.StepCounter(mesh) as counter:
        lm_mesh_step(step_fn, st, batches[-1], mesh, dev)
    steady = sorted(ms[1:])
    out["bf16"] = dict(B=B, S=S, first_ms=ms[0], p50_ms=percentile(
        steady, 0.5), p99_ms=percentile(steady, 0.99), peak_gib=peak,
        ce=ces, coll_bytes_per_step={a: b / LM_MESH_STEPS
                                     for a, b in by_axis.items()},
        flops_per_rank=counter.flops)
    if not all(math_isfinite(c) for c in ces):
        fail(f"13 (b): non-finite ce {ces}")
    del st
    torch.cuda.empty_cache()
    dist.barrier()

    # olmoe-1b-7b at full width cut to 2 layers, bfloat16, sharded
    cfg = dc.replace(get_arch("olmoe-1b-7b"), num_layers=2)
    step_fn = tstep.make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size, S, B, args.seed)
    st = lm_mesh_init(cfg, tcfg, args.seed, dev, mesh)
    oms, oces = [], []
    for _ in range(2):
        st, m, t = lm_mesh_step(step_fn, st, launch_train.to_batch(
            next(stream), "cpu"), mesh, dev)
        oms.append(t)
        oces.append(m["ce"])
    if not all(math_isfinite(c) for c in oces):
        fail(f"13 (b): olmoe non-finite ce {oces}")
    out["olmoe"] = dict(ms=oms, ce=oces,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del st
    torch.cuda.empty_cache()

    # the reduced olmoe (W = 2, experts over "data"): its sharded step on
    # the card == the same sharded step on CPU gloo ranks
    cfg = get_arch("olmoe-1b-7b").reduced()
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(
        **LM_TRAIN_CHECK_OPT))
    step_fn = tstep.make_train_step(cfg, tcfg)
    batch = lm_train_batch(cfg, *LM_MESH_MOE_SMALL, args.seed)
    card = tstep.shard_state(tstep.init_train_state(args.seed, cfg, tcfg,
                                                    device=dev), mesh)
    host = tstep.shard_state(lm_train_clone(
        tstep.unshard_state(card), tcfg, "cpu"), cpu_mesh)
    before = {k: v.clone() for k, v in io_flat(
        tstep.unshard_state(card)).items() if k.startswith("params/")}
    card, m_card, _ = lm_mesh_step(step_fn, card, batch, mesh, dev)
    host, m_host, _ = lm_mesh_step(step_fn, host, batch, cpu_mesh,
                                   torch.device("cpu"))
    card_full, host_full = (tstep.unshard_state(card),
                            tstep.unshard_state(host))
    if me:
        out["olmoe_small"] = lm_train_card_vs_cpu(
            before, card_full, host_full, m_card, m_host, 1e-3, tcfg,
            "13 (b) olmoe reduced sharded, card vs CPU ranks")
    launches = {k: m.launches for k, m in kernels.items()}
    if any(launches.values()):
        fail(f"13 (b): the sharded LM launched a kernel: {launches}")
    out["launches"] = launches
    dist.barrier()
    dist.destroy_process_group()
    print("LM-MESH-RESULT " + json.dumps(out), flush=True)
    return 0


def lm_mesh_shards(state, tcfg) -> dict:
    """This rank's shards of a sharded train state, as a train state of
    plain tensors (the same keys; each tensor the rank's own block)."""
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    loc = lambda t: t.detach().to_local()
    model = state["model"]
    local = transformer.Transformer(
        model.cfg, adamw.map_tree(loc, model.params.tree()),
        device=model.device)
    opt = {"mu": adamw.map_tree(loc, state["opt"]["mu"]),
           "nu": adamw.map_tree(loc, state["opt"]["nu"]),
           "step": state["opt"]["step"]}
    return tstep.train_state(local, tcfg, opt)


def io_flat(state) -> dict:
    from repro_torch.checkpoint import io
    return io.flatten_state(state)


def math_isfinite(x: float) -> bool:
    import math
    return math.isfinite(x)


def lm_mesh_run(args) -> list:
    """Phase 13 (b)'s LM_MESH_WORLD worker processes on this card."""
    work = ROOT / "build" / "repro_torch" / "lm_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--seed",
           str(args.seed)] + (["--src", str(args.src)] if args.src else [])
    procs, outs = [], []
    try:
        procs = [subprocess.Popen(
            cmd + ["--lm-mesh-worker", str(r), str(LM_MESH_WORLD),
                   str(work / "store")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(LM_MESH_WORLD)]
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=LM_MESH_TIMEOUT)
            outs.append(text)
            if p.returncode != 0:
                fail(f"phase 13 (b): rank {r} exited {p.returncode}:\n"
                     f"{text[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    ranks = []
    for r, text in enumerate(outs):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("LM-MESH-RESULT ")]
        if len(lines) != 1:
            fail(f"phase 13 (b): rank {r} printed no result:\n"
                 f"{text[-4000:]}")
        ranks.append(json.loads(lines[0][len("LM-MESH-RESULT "):]))
    return ranks


def lm_dryrun_beside(args, dev, b0: dict) -> dict:
    """Phase 13 (c): (b)'s bf16 configuration through the dry run on a
    fake (2, 2) world, against (b)'s real step; then the dry run of
    qwen3-0.6b on both production meshes with the DRF level."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import base
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.train import step as tstep
    cfg = get_arch("qwen3-0.6b")
    B, S = LM_TRAIN_FULL
    name = "mesh_check_train"
    base.INPUT_SHAPES[name] = dict(seq_len=S, global_batch=B, kind="train")
    try:
        mesh = dryrun.production_mesh(False, shape=LM_MESH_SHAPE)
        t0 = time.perf_counter()
        rec = dryrun.run_one(cfg.name, name, mesh=mesh, cfg=cfg,
                             verbose=False)
        dry_s = time.perf_counter() - t0
    finally:
        del base.INPUT_SHAPES[name]
        if dist.is_initialized():
            dist.destroy_process_group()
    if rec["status"] != "ok":
        fail(f"13 (c): the dry run of (b)'s configuration: {rec}")
    r = rec["roofline"]
    world = LM_MESH_SHAPE[0] * LM_MESH_SHAPE[1]
    # FlopCounterMode on the real one-device step of (b)'s configuration
    tcfg = tstep.TrainConfig()
    state = tstep.init_train_state(args.seed, cfg, tcfg, device=dev)
    batch = launch_train.to_batch(next(TokenStream(cfg.vocab_size, S, B,
                                                   args.seed)), dev)
    with FlopCounterMode(display=False) as fc:
        tstep.make_train_step(cfg, tcfg)(state, batch)
    torch.cuda.synchronize()
    del state
    torch.cuda.empty_cache()
    one = fc.get_total_flops()
    if r["flops_per_dev"] != b0["bf16"]["flops_per_rank"] or \
            r["flops_per_dev"] * world != one:
        fail(f"13 (c): dry-run FLOPs a rank {r['flops_per_dev']:.6e}, the "
             f"real sharded step's {b0['bf16']['flops_per_rank']:.6e}, "
             f"FlopCounterMode one device {one:.6e} / {world}")
    dry_peak = rec["memory"]["peak_bytes_per_device"] / 2**30
    real_peak = b0["bf16"]["peak_gib"]
    log(f"  (c) predicted, not measured: the dry run of (b)'s step on a fake "
        f"{LM_MESH_SHAPE} world ({dry_s:.1f} s): {r['flops_per_dev']:.6e} "
        f"FLOP a rank == (b)'s real step's (the rank's own ops) == "
        f"FlopCounterMode's one-device step / {world}; peak "
        f"{dry_peak:.2f} GiB a rank against (b)'s measured "
        f"{real_peak:.2f} GiB (ratio {dry_peak / real_peak:.3f}); terms "
        f"compute {r['compute_s'] * 1e3:.3f} ms, memory "
        f"{r['memory_s'] * 1e3:.3f} ms, collective "
        f"{r['collective_s'] * 1e3:.3f} ms")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str((args.src or ROOT / "src")))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "qwen3-0.6b", "--both-meshes", "--drf"],
                       capture_output=True, text=True, env=env,
                       timeout=LM_MESH_TIMEOUT)
    rows = [ln for ln in p.stdout.splitlines()
            if ln.startswith(("OK", "SKIP", "ERR"))]
    for ln in rows:
        log(f"  (c) predicted: {ln}")
    if p.returncode != 0:
        fail(f"13 (c): dryrun exited {p.returncode}:\n{p.stdout[-3000:]}"
             f"\n{p.stderr[-3000:]}")
    log(f"  (c) dryrun --arch qwen3-0.6b --both-meshes --drf: "
        f"{p.stdout.strip().splitlines()[-1]} in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(flops_per_rank=r["flops_per_dev"], one_device_flops=one,
                dry_peak_gib=dry_peak, real_peak_gib=real_peak,
                terms={k: r[k] for k in ("compute_s", "memory_s",
                                         "collective_s", "dominant")},
                rows=rows)


def phase13(args, dev, leo=None, maj=None) -> dict:
    """The legacy closures, sharded LM training, the dry run; see the
    module docstring."""
    import torch
    from repro_torch.core.dataset import from_numpy
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"  on {smi}")
    cut = 1 << args.train_log2n
    if leo is None:
        num, cat, y, arities = leo_dataset(args.seed, cut)
        leo = from_numpy(num, cat, y, arities)
        del num, cat, y
    if maj is None:
        m = majority_dataset(args.seed, cut)
        maj = from_numpy(m.num, None, m.labels)
        del m
    out = {"card": smi, "a": legacy_fits(args, dev, leo, maj)}
    del leo, maj
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = lm_mesh_run(args)
    r0 = ranks[0]
    log(f"  (b) {LM_MESH_WORLD} gloo ranks on this card, a {LM_MESH_SHAPE} "
        f"(data, model) DeviceMesh; gloo's eager collectives on CUDA "
        f"tensors: {json.dumps(r0['gloo_cuda'])} (DTensor's functional "
        f"collectives routed to them); workers {time.perf_counter() - t0:.1f}"
        f" s")
    log(f"  (b) qwen3-0.6b float32 B={LM_MESH_CHECK[0]} x "
        f"S={LM_MESH_CHECK[1]}: one sharded step == the one-device card "
        f"step ({lm_train_worst(r0['f32']['worst'])}); a repeat bit-equal")
    for r in ranks:
        b = r["bf16"]
        log(f"  (b) rank {r['rank']} qwen3-0.6b bf16 B={b['B']} x S={b['S']}"
            f", remat full: first step {b['first_ms']:.1f} ms, then p50 "
            f"{b['p50_ms']:.1f} / p99 {b['p99_ms']:.1f} ms a step, peak "
            f"{b['peak_gib']:.2f} GiB (phase 12 (c), one device: 10.79 "
            f"GiB); collective bytes a step {json.dumps(b['coll_bytes_per_step'])}"
            f"; ce {b['ce'][0]:.4f} -> {b['ce'][-1]:.4f}")
    log("  (b) the ranks share one card over gloo: these walls are no "
        "scaling figure")
    log(f"  (b) olmoe-1b-7b 2 layers bf16 sharded: steps "
        f"{[round(x, 1) for x in r0['olmoe']['ms']]} ms, ce "
        f"{r0['olmoe']['ce']}, peak {r0['olmoe']['peak_gib']:.2f} GiB; the "
        f"reduced olmoe's sharded step card == CPU ranks "
        f"({lm_train_worst(r0['olmoe_small'])})")
    out["b"] = ranks
    out["c"] = lm_dryrun_beside(args, dev, r0)
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches_lm"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  no kernel launched by the sharded LM ({json.dumps(launches)}); "
        f"phase 13 total {out['phase_s']:.1f} s")
    return out


def busy_within(merged, lo, hi) -> float:
    """Device-busy microseconds inside [lo, hi], from sorted disjoint
    busy intervals."""
    import bisect
    i = max(0, bisect.bisect_right(merged, [lo, float("inf")]) - 1)
    out = 0.0
    while i < len(merged) and merged[i][0] < hi:
        out += max(0.0, min(hi, merged[i][1]) - max(lo, merged[i][0]))
        i += 1
    return out


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
    merged = []                           # device busy intervals, us
    for e in sorted(work, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    busy_ms = sum(hi - lo for lo, hi in merged) / 1e3
    log(f"  profile: window {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms; "
        f"idle share {1 - busy_ms / wall_ms:.4f} of the profiled window, "
        f"{1 - busy_ms / (unprofiled_s * 1e3):.4f} of the unprofiled fit")
    # the pipelined loop: how much of the host's deferred book ran while
    # the device was busy, and how long the host then waited
    for name in ("level.book", "level.host_fetch"):
        host = [e for e in prof.events() if e.device_type == DeviceType.CPU
                and e.name == name]
        if not host:
            continue
        host_us = sum(e.time_range.end - e.time_range.start for e in host)
        under = sum(busy_within(merged, e.time_range.start,
                                e.time_range.end) for e in host)
        log(f"    host range {name}: {len(host)} calls, "
            f"{host_us / 1e3:.3f} ms on the host, the device busy for "
            f"{under / max(host_us, 1e-9):.4f} of it")
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

    # small fits on the card equal the CPU's plain-version fits
    rng = np.random.default_rng(args.seed)
    n = 20_000
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, a, n) for a in (5, 40, 300)], 1)
    y = ((num[:, 0] > 0) ^ (cat[:, 1] % 3 == 0)).astype(np.int32)
    small = from_numpy(num, cat, y)
    reg = from_numpy(num, cat, (3 * num[:, 0] + (cat[:, 1] % 4)
                                + 0.05 * rng.normal(size=n)).astype(
                                    np.float32), task="regression")
    regression = dict(task="regression", impurity="variance",
                      min_records=5)
    entropy = dict(impurity="entropy", min_records=10)
    cases = [("exact", small, dict()),
             ("hist with subtraction", small,
              dict(split_mode="hist", num_bins=HIST_BINS)),
             ("exact entropy", small, entropy),
             ("exact entropy, segment backend", small,
              dict(entropy, backend="segment")),
             ("exact regression", reg, dict(regression, max_depth=4)),
             ("hist regression", reg,
              dict(regression, split_mode="hist", num_bins=HIST_BINS))]
    for name, data, kw in cases:
        params = tree_lib.TreeParams(**dict(dict(max_depth=6,
                                                 backend="kernel"), **kw))
        gpu = RandomForest(params, num_trees=3, seed=args.seed,
                           tree_batch=3).fit(data)
        cpu = RandomForest(params, num_trees=3, seed=args.seed, tree_batch=3,
                           device="cpu").fit(data)
        if data.task == "classification":
            if not same_trees(gpu.trees, cpu.trees):
                fail(f"the card's small {name} fit differs from the CPU's")
            log(f"  small {name} fit: the card's trees equal the CPU "
                f"plain version's")
            continue
        # regression sums floats in other orders on the card: the same
        # structure, node values and thresholds within rtol 1e-5
        err = same_structure(gpu.trees, cpu.trees)
        if err is None or err > 1e-5:
            fail(f"the card's small {name} fit differs from the CPU's "
                 f"(relative value/threshold error {err})")
        again = RandomForest(params, num_trees=3, seed=args.seed,
                             tree_batch=3).fit(data)
        if not same_trees(gpu.trees, again.trees):
            fail(f"a repeat of the card's small {name} fit grew different "
                 f"trees")
        log(f"  small {name} fit: the card's trees have the CPU's "
            f"structure (values within {err:.2e} relative); a repeat on "
            f"the card is identical")
    return dict(auc=auc, predict_ms=pred_s * 1e3)


def same_structure(a, b):
    """None when the trees' structure differs, else the largest relative
    difference of node values and thresholds."""
    import numpy as np
    keys = ("feature", "is_cat", "cat_mask", "children", "depth")
    if len(a) != len(b) or not all(
            np.array_equal(getattr(x, k), getattr(y, k))
            for x, y in zip(a, b) for k in keys):
        return None
    err = 0.0
    for x, y in zip(a, b):
        for k in ("value", "threshold"):
            u, v = getattr(x, k), getattr(y, k)
            err = max(err, float((np.abs(u - v)
                                  / np.maximum(np.abs(v), 1e-6)).max()))
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-log2n", type=int, default=23)
    ap.add_argument("--check-log2n", type=int, default=20)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--skip-train", action="store_true",
                    help="stop after the kernel checks (development)")
    ap.add_argument("--exact-levels", action="store_true",
                    help="build, then only the per-level kernel checks and "
                         "times on the exact fit's inputs (development)")
    ap.add_argument("--bag", action="store_true",
                    help="build, then only the Poisson bag kernel's checks "
                         "and times at the main path's shapes (development)")
    ap.add_argument("--hist-levels", action="store_true",
                    help="build, then only feat_hist on the inputs of every "
                         "level of fit (b) (development)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="with --hist-levels: a directory holding the parent "
                         "tree's src/, whose feat_hist is run on the same "
                         "levels first and printed beside this tree's")
    ap.add_argument("--src", type=Path, default=None,
                    help="the src/ whose repro_torch to drive (default: the "
                         "one beside this script)")
    ap.add_argument("--levels-json", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--stream", action="store_true",
                    help="build, then only fit (b) in memory and phase 7 "
                         "(development)")
    ap.add_argument("--forests", action="store_true",
                    help="build, then only the forest fits of phases 3, 5 "
                         "and 6, each with its trees' sha256 (with --src: "
                         "another tree's port on the same rows)")
    ap.add_argument("--gbt", action="store_true",
                    help="build, then only phase 3's fit and phases 8-9 "
                         "(development)")
    ap.add_argument("--profile", action="store_true",
                    help="profile a third fit of each cell: device time "
                         "per part, idle share, the host's book")
    ap.add_argument("--dist", action="store_true",
                    help="build, then only the local fits phase 10 compares "
                         "against and phase 10")
    ap.add_argument("--dist-worker", nargs=3, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--lm", action="store_true",
                    help="build, then only phase 11 (LM serving)")
    ap.add_argument("--lm-train", action="store_true",
                    help="build, then only phase 12 (LM training)")
    ap.add_argument("--lm-mesh", action="store_true",
                    help="build, then only phase 13 (legacy closures, "
                         "sharded LM training, the dry run)")
    ap.add_argument("--lm-mesh-worker", nargs=3, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    src = (args.src or ROOT / "src").resolve()
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
    if args.dist_worker:
        return dist_worker(args)
    if args.lm_mesh_worker:
        return lm_mesh_worker(args)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log("phase 0: the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

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
        for fn, ops in sass_atomics(_build.library_path(name)).items():
            log(f"    {name} SASS atomics {fn}: {json.dumps(ops)}")

    if args.lm:
        log("phase 11: LM serving on the card")
        phase11(args, dev)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.lm_train:
        log("phase 12: LM training on the card")
        phase12(args, dev)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.lm_mesh:
        log("phase 13: legacy closures, sharded LM training, the dry run")
        phase13(args, dev)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0

    log("phase 2: kernels against their plain versions")
    if args.bag:
        bag_main_shapes(args, dev)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0
    n_all = (1 << args.train_log2n) + TEST_ROWS
    cut = 1 << args.train_log2n
    from repro_torch.core.dataset import from_numpy
    if not (args.exact_levels or args.hist_levels or args.stream
            or args.forests or args.gbt or args.dist):
        phase2(args, dev)
        deep_fit(args, dev)
    if args.hist_levels:
        old = (parent_feat_hist_levels(args, args.parent.resolve())
               if args.parent else None)
        maj = majority_dataset(args.seed, n_all)
        got = {"(b)": feat_hist_main_shapes(args, dev, from_numpy(
            maj.num[:cut], None, maj.labels[:cut]))["levels"]}
        del maj
        num, cat, y, arities = leo_dataset(args.seed, n_all)
        got["(a)"] = feat_hist_main_shapes(
            args, dev, from_numpy(num[:cut], cat[:cut], y[:cut], arities),
            "(a)")["levels"]
        del num, cat, y
        if args.levels_json:
            args.levels_json.write_text(json.dumps(got))
        for label in got if old else ():
            compare_hist_levels(got[label], old[label], label)
        return 0
    if args.stream:
        from repro_torch.kernels import feat_hist
        maj = majority_dataset(args.seed, cut)
        rf_b, _ = run_fit(args, maj, hist_params(args),
                          {"feat_hist": feat_hist}, "hist (b) majority")
        log("phase 7: streamed training")
        phase7(args, dev, src, maj, rf_b.trees)
        return 0
    t0 = time.perf_counter()
    num, cat, y, arities = leo_dataset(args.seed, n_all)
    if args.exact_levels:
        exact_main_levels(args, dev, from_numpy(num[:cut], cat[:cut],
                                                y[:cut], arities))
        return 0
    train = from_numpy(num[:cut], cat[:cut], y[:cut], arities)
    test = from_numpy(num[cut:], cat[cut:], y[cut:], arities)
    del num, cat, y
    if args.gbt:
        log("phase 3: train on the card")
        rf, _ = phase3(args, dev, train)
        exact_trees = rf.trees
        del rf
        log("phase 8: boosted trees on the card")
        gbt_a, _ = phase8(args, dev, train, test)
        log("phase 9: serving on the card")
        phase9(args, dev, exact_trees, test, gbt_a)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0
    maj = majority_dataset(args.seed, n_all)
    maj_train = from_numpy(maj.num[:cut], None, maj.labels[:cut])
    maj_test = from_numpy(maj.num[cut:], None, maj.labels[cut:])
    del maj
    log(f"  Leo-shaped data: {train.n} train + {test.n} test rows, "
        f"{train.m_num} numeric + {train.m_cat} categorical columns; "
        f"majority data: {maj_train.n} + {maj_test.n} rows, "
        f"{maj_train.m_num} numeric columns; made in "
        f"{time.perf_counter() - t0:.2f} s")
    if args.dist:
        log("phase 10: the local fits it compares against")
        refs = dist_refs(args, train, maj_train)
        log("phase 10: sharded training across ranks on the card")
        phase10(args, dev, maj_train, refs)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.forests:
        log("phase 3: train on the card")
        rf, _ = phase3(args, dev, train)
        exact_trees = rf.trees
        del rf
        log("phase 5: hist mode on the card")
        _, _, maj_exact = phase5(args, dev, train, test, maj_train, maj_test)
        log("phase 6: the reference's default path")
        phase6(args, dev, train, maj_train, exact_trees, maj_exact)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0
    main_rows = phase2_main_shapes(args, dev, train)
    exact_levels = exact_main_levels(args, dev, train)
    main_rows["feat_hist"] = feat_hist_main_shapes(args, dev, maj_train)
    log(f"  feat_hist main-path shapes {json.dumps(main_rows['feat_hist'])}")
    if args.skip_train:
        return 0

    log("phase 3: train on the card")
    rf, fit_info = phase3(args, dev, train)

    log("phase 4: predict")
    phase4(args, dev, rf, test)
    exact_trees = rf.trees
    del rf

    log("phase 5: hist mode on the card")
    _, hist_b, maj_exact = phase5(args, dev, train, test, maj_train,
                                  maj_test)

    log("phase 6: the reference's default path")
    info6 = phase6(args, dev, train, maj_train, exact_trees, maj_exact)
    refs = {"a": info6["a"]["sha256"], "b": hist_b["sha256"],
            "c": tree_digest(maj_exact.pop("trees"))}

    log("phase 7: streamed training")
    phase7(args, dev, src, maj_train, hist_b.pop("trees"))

    log("phase 8: boosted trees on the card")
    gbt_a, gbt_info = phase8(args, dev, train, test)

    log("phase 9: serving on the card")
    phase9(args, dev, exact_trees, test, gbt_a)
    del gbt_a

    log("phase 10: sharded training across ranks on the card")
    dist_info = phase10(args, dev, maj_train, refs)
    del maj_test
    sharded = {"cat_hist": "a", "feat_hist": "b", "breiman": "a"}

    log("phase 11: LM serving on the card")
    lm_info = phase11(args, dev)

    log("phase 12: LM training on the card")
    train_info = phase12(args, dev)

    log("phase 13: legacy closures, sharded LM training, the dry run")
    mesh_info = phase13(args, dev, train, maj_train)
    del maj_train

    kernels = []
    sources = {"split_scan": ("src/repro_torch/csrc/split_scan.cu",
                              "src/repro/kernels/split_scan.py:164",
                              fit_info),
               "cat_hist": ("src/repro_torch/csrc/cat_hist.cu",
                            "src/repro/kernels/cat_hist.py:64", fit_info),
               "feat_hist": ("src/repro_torch/csrc/feat_hist.cu",
                             "src/repro/kernels/feat_hist.py:83", hist_b),
               "breiman": ("src/repro_torch/csrc/breiman.cu",
                           "none (plain best_categorical_split_from_table, "
                           "src/repro/core/splits.py)", fit_info)}
    levels_ms = {"split_scan": exact_levels["split_scan_ms"],
                 "cat_hist": exact_levels["cat_hist_ms"],
                 "feat_hist": main_rows["feat_hist"]["levels_ms"],
                 "breiman": exact_levels["breiman_ms"]}
    for name, (source, replaces, run) in sources.items():
        r = main_rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=run["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], levels_ms=levels_ms[name],
            gbt={label: dict(launches=info["launches"][name],
                             **info["kernels"][name])
                 for label, info in gbt_info["fits"].items()
                 if name in info["kernels"]},
            sharded=({sharded[name]: [x[name] for x in dist_info["fits"][
                sharded[name]]["launches"]]} if name in sharded else {}),
            lm=dict(launches=lm_info["e"]["launches"].get(name, 0),
                    **(lm_info["e"]["split_scan"] if name == "split_scan"
                       else {})),
            lm_train=dict(launches=train_info["launches"][name]),
            legacy={label: info["launches"][name]
                    for label, info in mesh_info["a"].items()},
            lm_mesh=dict(launches=mesh_info["launches_lm"][name])))
    log(f"  phase 11 total {lm_info['phase_s']:.1f} s; phase 12 total "
        f"{train_info['phase_s']:.1f} s; phase 13 total "
        f"{mesh_info['phase_s']:.1f} s; whole script total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
