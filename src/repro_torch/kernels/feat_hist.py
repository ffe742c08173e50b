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
the design.  `feat_hist` launches it for CUDA tensors and takes the plain
version (`splits.feature_count_tables`, one flat `index_add_`) only for
CPU tensors.

Exactness, as for `cat_hist`: classification tables are integer counts
below 2^24, so the kernel's float atomics give the plain version's table
bit for bit; regression tables are summed in 64-bit fixed point
(deterministic run to run) and agree with the plain float32 `index_add_`
to |kernel - plain| <= 1e-4 · Σ|stat| per cell.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import splits
from repro_torch.kernels import _build
from repro_torch.kernels.cat_hist import fixed_point_scales

launches = 0                # kernel launches (tree groups of <= 8 trees)


def feat_hist_plain(x, slot, w, y, *, W, B, num_stats,
                    task="classification"):
    """The plain torch version: stats per row, one flat scatter-add."""
    stats = splits.row_stats(y, w, num_stats, task)            # (T, n, S)
    return splits.feature_count_tables(x, slot, w, stats, W - 1, B)


def _lib():
    lib = _build.load("feat_hist")
    if not getattr(lib, "_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.feat_hist_cls_launch.argtypes = ([p, i] + [p] * 3 + [i] * 6
                                             + [p, p])
        lib.feat_hist_cls_launch.restype = i
        lib.feat_hist_reg_launch.argtypes = ([p, i] + [p] * 3 + [i] * 5
                                             + [d] * 3 + [p, p, p])
        lib.feat_hist_reg_launch.restype = i
        lib.feat_hist_max_trees.restype = i
        lib._typed = True
    return lib


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


def feat_hist(x, slot, w, y, *, W, B, num_stats, task="classification"):
    """Bin tables (T, m, W, B, S): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return feat_hist_plain(x, slot, w, y, W=W, B=B, num_stats=num_stats,
                               task=task)
    if x.device.type != "cuda":
        raise ValueError(f"feat_hist runs on CUDA or CPU, not {x.device}")
    _check_inputs(x, slot, w, y)
    if task == "regression" and num_stats != 3:
        raise ValueError("feat_hist: regression has 3 stats per row")
    T, n = slot.shape
    m = x.shape[0]
    S = num_stats
    lib = _lib()
    group = lib.feat_hist_max_trees()
    dev = x.device
    out = torch.zeros((T, m, W, B, S), dtype=torch.float32, device=dev)
    scales = (fixed_point_scales(slot, w, y, W) if task == "regression"
              else None)
    P = _build.ptr
    nbytes = x.element_size()
    global launches
    for t0 in range(0, T, group):
        t1 = min(T, t0 + group)
        sl, ww = slot[t0:t1], w[t0:t1]
        if task == "classification":
            err = lib.feat_hist_cls_launch(
                P(x), nbytes, P(sl), P(ww), P(y), t1 - t0, m, n, W, B, S,
                P(out[t0:t1]), _build.stream_ptr(dev))
        else:
            acc = torch.zeros((t1 - t0, m, W, B, S), dtype=torch.int64,
                              device=dev)
            err = lib.feat_hist_reg_launch(
                P(x), nbytes, P(sl), P(ww), P(y), t1 - t0, m, n, W, B,
                *scales, P(acc), P(out[t0:t1]), _build.stream_ptr(dev))
        _build.check(err, "feat_hist launch")
        launches += 1
    return out


def bound_bytes(T: int, m: int, n: int, W: int, B: int, S: int,
                bin_bytes: int) -> int:
    """Bytes feat_hist must move: each input read once, the table written."""
    return m * n * bin_bytes + T * n * 8 + n * 4 + T * m * W * B * S * 4
