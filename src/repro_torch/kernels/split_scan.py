"""The exact numeric supersplit kernel (paper Alg. 1) and its plain version.

Replaces the TPU kernel `split_scan_pallas` (src/repro/kernels/split_scan.py,
body `_split_scan_kernel`).  Contract, for a batch of T trees over m
presorted columns of n rows:

    vals (m, n) f32      presorted values per column
    sidx (m, n) i32      row id of each presorted position
    leaf (T, n) i32      leaf id per row, 0 = closed
    w    (T, n) f32      bag weight per row
    y    (n,)   f32      class id (classification) or target (regression)
    cand (T, m, L1) bool candidate mask (leaf 0 = False)
    totals (T, L1, S)    the level's per-leaf stat totals: int32 class
                         counts (classification) or float32 sums
                         (regression)
    -> gain, thr (T, m, L1) f32: best split per (tree, column, leaf)

CUDA source: `repro_torch/csrc/split_scan.cu`, which states the bound and
the design: one packed 16-byte state word per (tree, row), gathered once
per presorted row, and a warp-parallel recurrence (lanes grouped by leaf
with `__match_any_sync`, every sum still taken in row order).  Its
per-leaf state lives in shared memory while it fits and in each block's
slice of the wrapper's scratch tensors past that, so the kernel takes any
frontier width (`state_layout`).  `split_scan` launches it for CUDA
tensors and takes the plain version only for CPU tensors;
`split_scan_plain` is the Pallas kernel's own recurrence in row blocks of
torch ops (`splits.scan_supersplit`).
Classification prefixes are int32 class counts in both, exact to 2^31,
each converted to float32 once where a gain is computed.  Binary
classification gains are bit-equal between the two at any row count
(integer prefixes, the same operation order).  With more classes, entropy or
regression they agree to float32 rounding of the impurity terms, which
are as large as the leaf's stat sums: |Δgain| <= 1e-6 · max|totals| (the
class sums are reduced in another order, regression prefixes are summed
in another order, and `log` may differ by an ulp).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import splits
from repro_torch.kernels import _build

IMPURITY = {"gini": 0, "entropy": 1, "variance": 2}
TASK = {"classification": 0, "regression": 1}

TILE = 256                  # rows a block stages per step (csrc TILE)
TARGET_BLOCKS = 132 * 32    # 32 one-warp blocks per SM of an H100
SCRATCH_BYTES = 1 << 30     # bound on the per-chunk scratch

launches = 0                # kernel launches (one per wrapper call)


def split_scan_plain(vals, sidx, leaf, w, y, cand, totals, *,
                     impurity="gini", task="classification",
                     min_records=1.0):
    """The plain torch version: gather the per-row state in presorted
    order and run the block recurrence over every (tree, column)."""
    T = leaf.shape[0]
    m, n = vals.shape
    S = totals.shape[-1]
    si = sidx.long()
    lf = leaf[:, si]                                           # (T, m, n)
    ww = w[:, si]
    yy = y[si]                                                 # (m, n)
    stats = splits.row_stats(yy, ww, S, task)                  # (T, m, n, S)
    L1 = cand.shape[-1]
    return splits.scan_supersplit(
        vals.expand(T, m, n), lf, ww, stats, cand,
        totals[:, None].expand(T, m, L1, S), impurity, task, min_records)


def chunking(n: int, tm: int, L1: int, S: int) -> tuple[int, int]:
    """(number of row chunks per column, rows per chunk) for the kernel:
    about TARGET_BLOCKS blocks in all, scratch within SCRATCH_BYTES."""
    tiles = max(1, -(-n // TILE))
    nc = min(tiles, max(1, -(-TARGET_BLOCKS // tm)))
    per_chunk = tm * L1 * (S + 3) * 4
    nc = max(1, min(nc, SCRATCH_BYTES // per_chunk))
    chunk = -(-tiles // nc) * TILE
    return max(1, -(-n // chunk)), chunk


def _lib():
    lib = _build.load("split_scan")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.split_scan_launch.argtypes = (
            [p] * 7 + [i] * 7 + [ctypes.c_float, i, ctypes.c_longlong]
            + [p] * 7 + [p])
        lib.split_scan_launch.restype = i
        lib.split_scan_max_stats.restype = i
        lib.split_scan_layout.argtypes = [i, i]
        lib.split_scan_layout.restype = i
        lib._typed = True
    return lib


def totals_dtype(task: str) -> torch.dtype:
    """The kernel's stat type: int32 class counts, or float32 sums."""
    return torch.int32 if task == "classification" else torch.float32


def _check_inputs(vals, sidx, leaf, w, y, cand, totals, task):
    T, n = leaf.shape
    m = vals.shape[0]
    L1, S = totals.shape[-2], totals.shape[-1]
    expect = {"vals": (vals, torch.float32, (m, n)),
              "sidx": (sidx, torch.int32, (m, n)),
              "leaf": (leaf, torch.int32, (T, n)),
              "w": (w, torch.float32, (T, n)),
              "y": (y, torch.float32, (n,)),
              "cand": (cand, torch.bool, (T, m, L1)),
              "totals": (totals, totals_dtype(task), (T, L1, S))}
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"split_scan: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"split_scan: {name} must be contiguous")
        if t.device != vals.device:
            raise ValueError(f"split_scan: {name} is on {t.device}, "
                             f"vals on {vals.device}")


def split_scan(vals, sidx, leaf, w, y, cand, totals, *, impurity="gini",
               task="classification", min_records=1.0):
    """Best (gain, threshold) per (tree, column, leaf): (T, m, L1) each.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if vals.device.type == "cpu":
        return split_scan_plain(vals, sidx, leaf, w, y, cand, totals,
                                impurity=impurity, task=task,
                                min_records=min_records)
    if vals.device.type != "cuda":
        raise ValueError(f"split_scan runs on CUDA or CPU, not {vals.device}")
    _check_inputs(vals, sidx, leaf, w, y, cand, totals, task)
    T, n = leaf.shape
    m = vals.shape[0]
    L1, S = totals.shape[-2], totals.shape[-1]
    lib = _lib()
    if S > lib.split_scan_max_stats():
        raise ValueError(f"split_scan: {S} stats per row is more than the "
                         f"kernel takes")
    nc, chunk = chunking(n, T * m, L1, S)
    dev = vals.device
    csum = torch.empty((T, m, nc, L1, S), dtype=totals.dtype, device=dev)
    clast, cgain, cthr = (torch.empty((T, m, nc, L1), dtype=torch.float32,
                                      device=dev) for _ in range(3))
    state = torch.empty((T, n, 4), dtype=torch.int32, device=dev)
    gain = torch.empty((T, m, L1), dtype=torch.float32, device=dev)
    thr = torch.empty_like(gain)
    P = _build.ptr
    err = lib.split_scan_launch(
        P(vals), P(sidx), P(leaf), P(w), P(y), P(cand.view(torch.uint8)),
        P(totals), T, m, n, L1, S, IMPURITY[impurity], TASK[task],
        float(min_records), nc, chunk, P(state), P(csum), P(clast),
        P(cgain), P(cthr), P(gain), P(thr), _build.stream_ptr(dev))
    _build.check(err, "split_scan launch")
    global launches
    launches += 1
    return gain, thr


def state_layout(L1: int, S: int) -> dict:
    """Where the kernel's two scan phases keep their per-leaf state at
    (L1, S) on the current card: "shared" or "global" each."""
    bits = _lib().split_scan_layout(L1, S)
    if bits < 0:
        raise RuntimeError("split_scan_layout: no CUDA device")
    return {"sums": "shared" if bits & 1 else "global",
            "best": "shared" if bits & 2 else "global"}


def bound_bytes(T: int, m: int, n: int, L1: int, S: int) -> int:
    """Bytes split_scan must move: each input read once, outputs written."""
    return (m * n * 8                  # vals + sidx
            + T * n * 8 + n * 4        # leaf + w, y
            + T * m * L1 * (1 + 2 * 4)  # cand in, gain + thr out
            + T * L1 * S * 4)          # totals

