"""Hist-mode bin tables for all numeric columns in one row pass: the CUDA
kernel and its plain version.

Replaces the TPU kernel `feat_hist_pallas` (src/repro/kernels/feat_hist.py,
body `_feat_hist_kernel`).  Contract, for a batch of T trees over m
numeric columns of n rows:

    x    (m, n) uint8|uint16  bucket id per row and column
    slot (T, n) i32           scatter slot per row, 0 = discard
    w    (T, n) f32           bag weight per row
    y    (n,)   f32           class id (classification) or target (regression)
    -> (T, m, W, B, S) f32: per (tree, column, slot, bin) the sum of the
       in-bag rows' stats, w·onehot(y) or [w, wy, wy²]

`slot` is the raw leaf id on the plain path; under histogram subtraction
it is `slot_of[leaf_of]`, with the rows of derive leaves mapped to 0.
CUDA source: `repro_torch/csrc/feat_hist.cu`, which states the bound and
the design: where one column's table fits a block's shared memory, the
per-row state is packed into one word and blocks of (tree, column group,
row range) build their tables there and add them into the output
(`hist_plan` sizes the groups and ranges from the shapes alone);
elsewhere each row adds into device memory.  `feat_hist` launches
it for CUDA tensors and takes the plain version
(`splits.feature_count_tables`, one flat `index_add_`) only for CPU
tensors.

Exactness: classification tables are float32 integer counts, exact below
2^24, where the tree drivers hold a hist-mode tree (its in-bag weight,
`plan.count_limit`; the exact path's tables are int32), so the kernel's
integer counts and float atomics give the plain version's table bit for
bit; regression tables are summed in 64-bit
fixed point by both (`cat_hist.fixed_point_sums`), so they give the same
bits on both paths.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import splits
from repro_torch.kernels import _build
from repro_torch.kernels.cat_hist import (TASK, _check_fixed, count_wmax,
                                          fixed_point_scales,
                                          fixed_point_sums, from_fixed_point)

launches = 0                # kernel launches (tree groups of <= 8 trees)

SMEM_OPTIN = 227 * 1024     # H100: the most shared memory one block takes
SM_COUNT = 132              # H100 SXM; shared-path blocks run one per SM
MIN_ROWS = 4096             # fewest rows a shared-path block takes
CONTENDED_CELLS = 4096      # cells of a (tree, column) table below which
                            # device-memory adds collide
MANY_COLUMNS = 8            # columns from which the shared path's pass
                            # over the rows pays on a wide table


def feat_hist_plain(x, slot, w, y, *, W, B, num_stats,
                    task="classification", scales=None, fixed=False):
    """The plain torch version: stats per row, one flat scatter-add.
    Regression sums in the kernel's 64-bit fixed point
    (`cat_hist.fixed_point_sums`), so both give the same bits; `scales`
    and `fixed` as for `feat_hist`."""
    stats = splits.row_stats(y, w, num_stats, task)            # (T, n, S)
    if task != "regression":
        _check_fixed(task, scales, fixed)
        return splits.feature_count_tables(x, slot, w, stats, W - 1, B)
    if scales is None:
        scales = fixed_point_scales(slot, w, y, W)
    acc = fixed_point_sums(
        lambda q: splits.feature_count_tables(x, slot, w, q, W - 1, B),
        stats, scales)
    return acc if fixed else from_fixed_point(acc, scales)


def _lib():
    lib = _build.load("feat_hist")
    if not getattr(lib, "_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.feat_hist_shared_launch.argtypes = ([i, p, i] + [p] * 3
                                                + [i] * 11 + [ctypes.c_float]
                                                + [d] * 3 + [p] * 5)
        lib.feat_hist_device_launch.argtypes = ([i, p, i] + [p] * 3 + [i] * 6
                                                + [d] * 3 + [p] * 3)
        for fn in (lib.feat_hist_shared_launch, lib.feat_hist_device_launch,
                   lib.feat_hist_max_trees, lib.feat_hist_smem_optin,
                   lib.feat_hist_sm_count):
            fn.restype = i
        lib.max_trees = lib.feat_hist_max_trees()
        lib.smem_optin = lib.feat_hist_smem_optin()
        lib.sm_count = lib.feat_hist_sm_count()
        lib._typed = True
    return lib


@dataclasses.dataclass(frozen=True)
class HistPlan:
    """How one tree group's tables are built.  `shared`: blocks of G
    columns (nG groups) and R rows (nR ranges), each holding its columns'
    tables in `smem` bytes of shared memory; else the device path (one
    thread per row, atomics into device memory; the other fields unused)."""
    shared: bool
    G: int = 0
    nG: int = 0
    R: int = 0
    nR: int = 0
    smem: int = 0


def column_bytes(W: int, B: int, S: int, task: str = "classification") -> int:
    """Shared memory of one column's table: slots 1..W-1 (slot 0 is never
    stored) x B bins x S uint32/float32 cells (classification) or 3 uint64
    cells (regression)."""
    cell = S * 4 if task == "classification" else 24
    return max(0, W - 1) * B * cell


@functools.lru_cache(maxsize=256)
def hist_plan(T: int, m: int, n: int, W: int, B: int, S: int,
              task: str = "classification", *, budget: int = SMEM_OPTIN,
              sms: int = SM_COUNT, min_rows: int = MIN_ROWS) -> HistPlan:
    """The plan of one tree group, from the shapes alone (no host sync).

    The shared path packs every (tree, row)'s state into a word, then
    blocks of G columns read each word once per column group; the device
    path adds each (row, column) into device memory, which is cheap unless
    the adds collide.  So the shared path is taken where one column's
    table fits `budget` and either the table is narrow (a classification
    table of at most CONTENDED_CELLS cells, where device adds pile up) or
    there are MANY_COLUMNS columns or more, or the task is regression
    (whose device path adds three 64-bit values a row).  Its blocks take
    as many columns as fit, the groups balanced, and the rows are cut into
    ranges so that the T x nG x nR blocks make one wave (one block per
    SM), each of at least `min_rows` rows.  Else the device path."""
    col = column_bytes(W, B, S, task)
    cells = max(0, W - 1) * B * (S if task == "classification" else 3)
    narrow = cells <= CONTENDED_CELLS
    # a row's packed word holds its cell offset in 16 bits
    if col > budget or cells > 0xFFFF or not (
            narrow or m >= MANY_COLUMNS or task == "regression"):
        return HistPlan(shared=False)
    G = m if col == 0 else min(m, budget // col)
    nG = -(-m // G)
    G = -(-m // nG)
    nR = max(1, min(sms // (T * nG), -(-n // min_rows)))
    R = -(-(-(-n // nR)) // 32) * 32
    return HistPlan(shared=True, G=G, nG=nG, R=R, nR=-(-n // R),
                    smem=-(-G * col // 16) * 16)


def _check_inputs(x, slot, w, y):
    if x.dtype not in (torch.uint8, torch.uint16) or x.dim() != 2:
        raise ValueError(f"feat_hist: x must be uint8 or uint16 (m, n), got "
                         f"{x.dtype} {tuple(x.shape)}")
    T, n = slot.shape
    expect = {"x": (x, x.dtype, (x.shape[0], n)),
              "slot": (slot, torch.int32, (T, n)),
              "w": (w, torch.float32, (T, n)),
              "y": (y, torch.float32, (n,))}
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"feat_hist: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"feat_hist: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"feat_hist: {name} is on {t.device}, "
                             f"x on {x.device}")


def feat_hist(x, slot, w, y, *, W, B, num_stats, task="classification",
              scales=None, fixed=False):
    """Bin tables (T, m, W, B, S): the kernel for CUDA tensors, the plain
    version for CPU tensors.  Regression only: `scales` replaces the
    scales picked from these rows and `fixed=True` returns the int64
    fixed-point sums, as for `cat_hist.cat_hist`."""
    if x.device.type == "cpu":
        return feat_hist_plain(x, slot, w, y, W=W, B=B, num_stats=num_stats,
                               task=task, scales=scales, fixed=fixed)
    if x.device.type != "cuda":
        raise ValueError(f"feat_hist runs on CUDA or CPU, not {x.device}")
    _check_inputs(x, slot, w, y)
    if task == "regression" and num_stats != 3:
        raise ValueError("feat_hist: regression has 3 stats per row")
    T, n = slot.shape
    m = x.shape[0]
    S = num_stats
    lib = _lib()
    group = lib.max_trees
    dev = x.device
    out = torch.zeros((T, m, W, B, S), dtype=torch.float32, device=dev)
    acc = None
    if task == "regression":
        if scales is None:
            scales = fixed_point_scales(slot, w, y, W)
        acc = torch.zeros((T, m, W, B, S), dtype=torch.int64, device=dev)
    else:
        _check_fixed(task, scales, fixed)
    s0, s1, s2 = scales if scales is not None else (1.0, 1.0, 1.0)
    wmax = min(count_wmax(n), 65535.0)      # a weight packs in 16 bits
    P = _build.ptr
    stream = _build.stream_ptr(dev)
    global launches
    for t0 in range(0, T, group):
        t1 = min(T, t0 + group)
        plan = hist_plan(t1 - t0, m, n, W, B, S, task,
                         budget=min(SMEM_OPTIN, lib.smem_optin),
                         sms=lib.sm_count)
        head = (TASK[task], P(x), x.element_size(), P(slot[t0:t1]),
                P(w[t0:t1]), P(y), t1 - t0, m, n, W, B, S)
        outs = (P(out[t0:t1]), None if acc is None else P(acc[t0:t1]),
                stream)
        if plan.shared:
            # the flag, then the packed words (T, n)
            scratch = torch.empty(1 + (t1 - t0) * n, dtype=torch.int32,
                                  device=dev)
            err = lib.feat_hist_shared_launch(
                *head, plan.G, plan.nG, plan.R, plan.nR, plan.smem, wmax,
                s0, s1, s2, P(scratch[1:]), P(scratch), *outs)
        else:
            err = lib.feat_hist_device_launch(*head, s0, s1, s2, *outs)
        _build.check(err, "feat_hist launch")
        launches += 1
    return acc if fixed else out


def bound_bytes(T: int, m: int, n: int, W: int, B: int, S: int,
                bin_bytes: int) -> int:
    """Bytes feat_hist must move: each input read once, the table written."""
    return m * n * bin_bytes + T * n * 8 + n * 4 + T * m * W * B * S * 4
