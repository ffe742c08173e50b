"""Categorical count tables (paper §2.4): the CUDA kernel and its plain
version.

Replaces the TPU kernel `cat_hist_pallas` (src/repro/kernels/cat_hist.py,
body `_cat_hist_kernel`).  Contract, for a batch of T trees over m
categorical columns of n rows:

    x    (m, n) i32      category per row, in [0, V)
    leaf (T, n) i32      leaf id per row, 0 = closed
    w    (T, n) f32      bag weight per row
    y    (n,)   f32      class id (classification) or target (regression)
    -> (T, m, L1, V, S) f32: per (tree, column, leaf, category) the sum of
       the in-bag rows' stats, w·onehot(y) or [w, wy, wy²]

The per-row state is read once as (T, n), never broadcast to (m, n).
CUDA source: `repro_torch/csrc/cat_hist.cu`, which states the bound and
the design: the rows are bucketed by leaf (`leaf_buckets`), each table
tile is built in a block's shared memory and written once, and the host
plans the tiles (`tile_plan`) and the blocks' row ranges (`tile_work`)
from the per-leaf row counts.  `cat_hist` launches it for CUDA tensors
and takes the plain version (one flat `index_add_` per column) only for
CPU tensors; so do `leaf_buckets` and its plain version.

Exactness: classification tables are integer counts below 2^24, so the
kernel's float atomics give the plain version's table bit for bit.
Regression tables are summed in 64-bit fixed point (deterministic run to
run, see the source), and so is the plain version (`fixed_point_sums`):
the two give the same bits, on the card and on the CPU.  (A float32
`index_add_` of a cell of millions of rows, as GBT's shallow levels have,
is off from the exact sum by far more than one float32 rounding.)
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import splits
from repro_torch.kernels import _build

TASK = {"classification": 0, "regression": 1}

launches = 0                # kernel launches (tree groups of <= 8 trees)


def cat_hist_plain(x, leaf, w, y, *, L1, V, num_stats,
                   task="classification", scales=None, fixed=False):
    """The plain torch version: stats per row, one flat scatter-add.
    Regression sums in the kernel's 64-bit fixed point
    (`fixed_point_sums`), so both give the same bits; `scales` and
    `fixed` as for `cat_hist`."""
    stats = splits.row_stats(y, w, num_stats, task)            # (T, n, S)
    if task != "regression":
        _check_fixed(task, scales, fixed)
        return splits.categorical_count_tables(x, leaf, w, stats, L1 - 1, V)
    if scales is None:
        scales = fixed_point_scales(leaf, w, y, L1)
    acc = fixed_point_sums(
        lambda q: splits.categorical_count_tables(x, leaf, w, q, L1 - 1, V),
        stats, scales)
    return acc if fixed else from_fixed_point(acc, scales)


def _check_fixed(task, scales, fixed):
    """Explicit scales and int64 sums exist for regression tables only."""
    if scales is not None or fixed:
        raise ValueError(f"{task} tables are float counts: scales and "
                         f"fixed=True are for regression only")


def fixed_point_sums(scatter, stats, scales):
    """`scatter` (a plain table's scatter-add) over the row stats in the
    kernels' 64-bit fixed point: each float32 stat times its channel's
    power-of-two scale, rounded to the nearest integer (ties to even);
    the int64 sums are exact in any order."""
    s = torch.tensor(scales, dtype=torch.float64, device=stats.device)
    return scatter(torch.round(stats.double() * s).long())


def from_fixed_point(acc, scales):
    """int64 fixed-point sums times 1/scale, rounded once to float32: the
    kernels' last pass."""
    s = torch.tensor(scales, dtype=torch.float64, device=acc.device)
    return (acc.double() * (1.0 / s)).to(torch.float32)


def _lib():
    lib = _build.load("cat_hist")
    if not getattr(lib, "_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.cat_bucket_launch.argtypes = ([p] * 3 + [i] * 5
                                          + [ctypes.c_float, i] + [p] * 8)
        lib.cat_hist_launch.argtypes = ([i, i] + [p] * 4 + [i] * 12
                                        + [ctypes.c_float, i, i, i] + [d] * 3
                                        + [p] * 5)
        lib.cat_plan_launch.argtypes = [p] + [i] * 8 + [p, p]
        for fn in (lib.cat_bucket_launch, lib.cat_hist_launch,
                   lib.cat_plan_launch, lib.cat_hist_max_trees,
                   lib.cat_hist_smem_optin):
            fn.restype = i
        lib.max_trees = lib.cat_hist_max_trees()
        lib.smem_optin = lib.cat_hist_smem_optin()
        lib._typed = True
    return lib


def _check_inputs(x, leaf, w, y):
    T, n = leaf.shape
    m = x.shape[0]
    expect = {"x": (x, torch.int32, (m, n)),
              "leaf": (leaf, torch.int32, (T, n)),
              "w": (w, torch.float32, (T, n)),
              "y": (y, torch.float32, (n,))}
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"cat_hist: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"cat_hist: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"cat_hist: {name} is on {t.device}, "
                             f"x on {x.device}")


def fixed_point_mags(leaf, w, y, L1):
    """The largest |stat| per regression channel over the rows that land
    in a table, (3,) float32 on the rows' device.  Row shards take the
    maximum of theirs (an all-reduce) to share one set of scales."""
    inb = (w > 0) & (leaf > 0) & (leaf < L1)
    wy = w * y
    return torch.stack([torch.where(inb, w, 0.0).abs().amax(),
                        torch.where(inb, wy, 0.0).abs().amax(),
                        torch.where(inb, wy * y, 0.0).abs().amax()])


def fixed_point_scales(leaf, w, y, L1):
    """One power-of-two scale per regression stat channel: the largest that
    keeps n · max|stat| · scale below 2^61, so no int64 sum can overflow."""
    return power_of_two_scales(fixed_point_mags(leaf, w, y, L1).tolist(),
                               leaf.shape[-1])


def power_of_two_scales(mags, n: int) -> list:
    """The largest power of two per magnitude in `mags` that keeps
    n · mag · scale below 2^61."""
    n_bits = max(1, math.ceil(math.log2(max(n, 2))))
    scales = []
    for mag in mags:
        e = 0 if not mag > 0 else 61 - n_bits - math.frexp(mag)[1]
        scales.append(2.0 ** max(-1000, min(1000, e)))
    return scales


# ---------------------------------------------------------------------------
# The host side of the kernel: leaf buckets, the tile plan, the work items
# ---------------------------------------------------------------------------

SMEM_BUDGET = 100 * 1024    # shared memory of a tile block: two per SM
COLUMN_BLOCKS = 384         # row pieces per column: the blocks of one
                            # column fill the card (1.5 waves of two per
                            # SM), so that column stays in L2 while they run
MIN_PIECE = 16384           # fewest rows a block of a split tile takes
BUCKET_CELLS = 1 << 24      # bound on the (T, L1, chunks) count table


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the (L1, V) table of one (tree, column) is cut into tiles:
    LT leaves x CT categories each, nLT x nCT of them.  `natural`: the
    whole table is one tile, so the rows need no bucketing."""
    LT: int
    nLT: int
    CT: int
    nCT: int

    @property
    def natural(self) -> bool:
        return self.nLT == 1 and self.nCT == 1


def tile_plan(L1: int, V: int, S: int, task: str = "classification",
              budget: int = SMEM_BUDGET) -> TilePlan:
    """The largest tiles that fit in `budget` bytes of shared memory: all
    categories of as many leaves as fit, else category tiles of one leaf
    (cells of S float32 for classification, 3 uint64 for regression; 4
    bytes per leaf and one more for the tile's list bounds; 16-byte
    padding after each part)."""
    cell = S * 4 if task == "classification" else 24
    CT = max(1, min(V, (budget - 40) // cell))
    nCT = -(-V // CT)
    CT = -(-V // nCT)
    LT = (max(1, min(L1, (budget - 36) // (V * cell + 4))) if nCT == 1
          else 1)
    return TilePlan(LT=LT, nLT=-(-L1 // LT), CT=CT, nCT=nCT)


def bucket_chunks(n: int, T: int, L1: int) -> tuple[int, int]:
    """(chunks per tree, rows per chunk) of the bucketing: one warp per
    chunk of about 1024 rows, the count table within BUCKET_CELLS."""
    nb = max(1, min(-(-n // 1024), BUCKET_CELLS // max(1, T * L1)))
    rows = -(-(-(-n // nb)) // 32) * 32
    return max(1, -(-n // rows)), rows


class Buckets(NamedTuple):
    """Each tree's in-bag rows of open leaves (0 < leaf < L1, w > 0),
    ordered by leaf and, within a leaf, by row: the (T, n) lists of row
    ids, weights and labels (entries past lstart[:, -1] are the other rows
    in the plain version, unwritten by the kernel), the per-leaf list
    offsets lstart (T, L1+1) int32, and on the card `odd`, a one-element
    int32 tensor set to 1 when a listed weight is not an integer small
    enough for the tables' 32-bit counts (n · w < 2^32).  With `classes`
    = C > 0 the row word holds row · (C+1) + class (C for a label outside
    [0, C)) and there is no label list (y None)."""
    rows: torch.Tensor
    w: torch.Tensor
    y: Optional[torch.Tensor]
    lstart: torch.Tensor
    odd: Optional[torch.Tensor] = None


def leaf_buckets_plain(leaf, w, y, L1, classes: int = 0) -> Buckets:
    """The plain version of `leaf_buckets`: a stable argsort by leaf."""
    act = (w > 0) & (leaf > 0) & (leaf < L1)
    key = torch.where(act, leaf, L1).long()
    order = torch.argsort(key, dim=1, stable=True)
    counts = torch.zeros((leaf.shape[0], L1 + 1), dtype=torch.int64,
                         device=leaf.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    lstart = torch.zeros_like(counts)
    lstart[:, 1:] = counts[:, :L1].cumsum(1)
    if classes:
        cls = y.to(torch.int32)
        cls = torch.where((cls >= 0) & (cls < classes), cls, classes)
        return Buckets((order * (classes + 1) + cls[order]).to(torch.int32),
                       torch.gather(w, 1, order), None,
                       lstart.to(torch.int32))
    return Buckets(order.to(torch.int32), torch.gather(w, 1, order),
                   y[order], lstart.to(torch.int32))


def leaf_buckets(leaf, w, y, L1, classes: int = 0) -> Buckets:
    """The rows bucketed by leaf (`Buckets`): the bucketing kernels for
    CUDA tensors (a count pass, the offsets, a stable scatter), the plain
    version for CPU tensors."""
    if leaf.device.type == "cpu":
        return leaf_buckets_plain(leaf, w, y, L1, classes)
    T, n = leaf.shape
    nb, chunk = bucket_chunks(n, T, L1)
    dev = leaf.device
    ints = torch.empty(T * L1 * nb + T * L1 + T * (L1 + 1) + 1,
                       dtype=torch.int32, device=dev)
    cnt, total, lstart, odd = torch.split(
        ints, [T * L1 * nb, T * L1, T * (L1 + 1), 1])
    lists = torch.empty((2 if classes else 3, T, n), dtype=torch.float32,
                        device=dev)
    rows = lists[0].view(torch.int32)
    yl = None if classes else lists[2]
    P = _build.ptr
    _build.check(_lib().cat_bucket_launch(
        P(leaf), P(w), P(y), T, n, L1, chunk, nb, count_wmax(n),
        classes + 1 if classes else 0,
        P(cnt), P(total), P(lstart), P(rows), P(lists[1]),
        None if yl is None else P(yl), P(odd), _build.stream_ptr(dev)),
        "cat_hist bucketing")
    return Buckets(rows, lists[1], yl, lstart.view(T, L1 + 1), odd)


def count_wmax(n: int) -> float:
    """The largest weight the tables' 32-bit integer counts take for n
    rows (n · w < 2^32); a larger or fractional weight sums in float."""
    return float((2**32 - 1) // max(n, 1))


def piece_rows(n: int, T: int, target: int = COLUMN_BLOCKS,
               min_piece: int = MIN_PIECE) -> int:
    """Rows per block of a split tile: at least `min_piece` (its flush
    adds up to a tile of atomics), and few enough that the T·n rows of one
    column make about `target` blocks."""
    return max(min_piece, -(-T * n // target))


def work_rows(plan: TilePlan, n: int, T: int, piece: int) -> int:
    """Work items the plan can need at most: one per (tree, leaf tile)
    plus one per `piece` rows."""
    return T * plan.nLT + T * n // piece


def tile_work(lstart, plan: TilePlan, n: int, T: int, *,
              target: int = COLUMN_BLOCKS, min_piece: int = MIN_PIECE,
              device=None):
    """The blocks' work items, (work_rows, 5) int32 rows {tree, leaf tile,
    k0, k1, flag}: per (tree, leaf tile) its rows [k0, k1) of the tree's
    list (lstart (T, L1+1); with `plan.natural`, lstart None, the natural
    rows [0, n)), cut in k = max(1, ceil(rows / piece)) even pieces
    (`piece_rows`).  flag: 0 for a tile stored whole, 1 for the first
    piece of a split tile, 2 for its other pieces (split tiles are added
    with atomics into a zeroed region).  Rows past the last item are
    {-1, 0, 0, 0, 0}.  The `cat_plan` kernel for a CUDA lstart (or
    `device`), this plain version otherwise."""
    piece = piece_rows(n, T, target, min_piece)
    W = work_rows(plan, n, T, piece)
    dev = torch.device(device) if lstart is None and device is not None \
        else (lstart.device if lstart is not None else torch.device("cpu"))
    if dev.type == "cuda":
        work = torch.empty((W, 5), dtype=torch.int32, device=dev)
        P = _build.ptr
        _build.check(_lib().cat_plan_launch(
            None if lstart is None else P(lstart), int(plan.natural), T, n,
            0 if lstart is None else lstart.shape[1] - 1, plan.LT, plan.nLT,
            piece, W, P(work), _build.stream_ptr(dev)), "cat_hist plan")
        return work
    if plan.natural:
        lo = np.zeros((T, 1), np.int64)
        hi = np.full((T, 1), n, np.int64)
    else:
        ls = lstart.numpy()
        L1 = ls.shape[1] - 1
        edges = np.minimum(np.arange(plan.nLT + 1) * plan.LT, L1)
        lo = ls[:, edges[:-1]].astype(np.int64)
        hi = ls[:, edges[1:]].astype(np.int64)
    rows = hi - lo                                           # (T, nLT)
    pieces = np.maximum(1, -(-rows // piece)).reshape(-1)
    tt, lt = np.divmod(np.arange(rows.size), rows.shape[1])
    item = np.repeat(np.arange(rows.size), pieces)
    p = np.arange(item.size) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    lo, rows = lo.reshape(-1)[item], rows.reshape(-1)[item]
    k = pieces[item]
    flag = np.where(k == 1, 0, np.where(p == 0, 1, 2))
    work = np.zeros((W, 5), np.int64)
    work[:, 0] = -1
    work[:item.size] = np.stack([tt[item], lt[item], lo + rows * p // k,
                                 lo + rows * (p + 1) // k, flag], 1)
    return torch.from_numpy(work.astype(np.int32))


def zero_split_tiles(out, work, plan: TilePlan) -> None:
    """The plain version of `cat_zero_split`: zero the region of `out`
    (T, m, L1, V, S) of every (tree, leaf tile) that `work` splits over
    several blocks (their atomic adds land there); every other cell is
    stored whole by its one block."""
    for t, lt in work[work[:, 4] == 1, :2].tolist():
        out[t, :, lt * plan.LT:(lt + 1) * plan.LT].zero_()


def _group_tables(lib, plan, x, leaf, w, y, L1, V, S, task, scales, out,
                  acc):
    """One tree group's tables into `out` (T, m, L1, V, S), regression's
    int64 sums into the zeroed `acc` of the same shape: one call that
    buckets the rows (unless the plan is natural), plans the work on the
    card and builds the tiles; the wrapper only allocates."""
    T, n = leaf.shape
    m = x.shape[0]
    dev = x.device
    P = _build.ptr
    piece = piece_rows(n, T)
    W = work_rows(plan, n, T, piece)
    nb, chunk = bucket_chunks(n, T, L1)
    # classification packs each row's class into its row word
    pack = S + 1 if task == "classification" and n * (S + 1) < 2**31 else 0
    lists = None
    n_ints = W * 5
    if not plan.natural:
        n_ints += T * L1 * nb + T * L1 + T * (L1 + 1) + 1
        lists = torch.empty((2 if pack else 3, T, n), dtype=torch.float32,
                            device=dev)
    ints = torch.empty(n_ints, dtype=torch.int32, device=dev)
    s0, s1, s2 = scales if scales else (1.0, 1.0, 1.0)
    err = lib.cat_hist_launch(
        TASK[task], int(plan.natural), P(x), P(leaf), P(w), P(y), T, m, n,
        L1, V, S, plan.LT, plan.nLT, plan.CT, plan.nCT, chunk, nb,
        count_wmax(n), piece, W, pack, s0, s1, s2,
        P(ints), None if lists is None else P(lists), P(out),
        None if acc is None else P(acc), _build.stream_ptr(dev))
    _build.check(err, "cat_hist launch")


def cat_hist(x, leaf, w, y, *, L1, V, num_stats, task="classification",
             scales=None, fixed=False):
    """Count tables (T, m, L1, V, S): the kernel for CUDA tensors, the
    plain version for CPU tensors.

    Regression only: `scales` (three powers of two) replaces the scales
    picked from these rows, and `fixed=True` returns the int64 fixed-point
    sums instead of the float32 tables.  Row shards pass the scales of the
    whole row set and add their sums before one `from_fixed_point`, which
    gives the one-device table bit for bit."""
    if x.device.type == "cpu":
        return cat_hist_plain(x, leaf, w, y, L1=L1, V=V, num_stats=num_stats,
                              task=task, scales=scales, fixed=fixed)
    if x.device.type != "cuda":
        raise ValueError(f"cat_hist runs on CUDA or CPU, not {x.device}")
    _check_inputs(x, leaf, w, y)
    if task == "regression" and num_stats != 3:
        raise ValueError("cat_hist: regression has 3 stats per row")
    T, n = leaf.shape
    m = x.shape[0]
    S = num_stats
    lib = _lib()
    plan = tile_plan(L1, V, S, task, min(SMEM_BUDGET, lib.smem_optin))
    out = torch.empty((T, m, L1, V, S), dtype=torch.float32, device=x.device)
    acc = None
    if task == "regression":
        if scales is None:
            scales = fixed_point_scales(leaf, w, y, L1)
        acc = torch.zeros((T, m, L1, V, S), dtype=torch.int64,
                          device=x.device)
    else:
        _check_fixed(task, scales, fixed)
    group = lib.max_trees
    global launches
    for t0 in range(0, T, group):
        t1 = min(T, t0 + group)
        _group_tables(lib, plan, x, leaf[t0:t1], w[t0:t1], y, L1, V, S, task,
                      scales, out[t0:t1],
                      None if acc is None else acc[t0:t1])
        launches += 1
    return acc if fixed else out


def bound_bytes(T: int, m: int, n: int, L1: int, V: int, S: int) -> int:
    """Bytes cat_hist must move: each input read once, the table written."""
    return m * n * 4 + T * n * 8 + n * 4 + T * m * L1 * V * S * 4
