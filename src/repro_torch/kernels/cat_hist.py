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
the design.  `cat_hist` launches it for CUDA tensors and takes the plain
version (one flat `index_add_` per column) only for CPU tensors.

Exactness: classification tables are integer counts below 2^24, so the
kernel's float atomics give the plain version's table bit for bit.
Regression tables are summed in 64-bit fixed point (deterministic run to
run, see the source) and agree with the plain float32 `index_add_` to
float32 rounding of the plain sums: |kernel - plain| <= 1e-4 · Σ|stat| per
cell (a float32 sum of k terms is off by up to about k·2^-24 of Σ|stat|,
and a cell of these tables sums up to ~10^4 rows).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import splits
from repro_torch.kernels import _build

launches = 0                # kernel launches (tree groups of <= 8 trees)


def cat_hist_plain(x, leaf, w, y, *, L1, V, num_stats,
                   task="classification"):
    """The plain torch version: stats per row, one flat scatter-add."""
    stats = splits.row_stats(y, w, num_stats, task)            # (T, n, S)
    return splits.categorical_count_tables(x, leaf, w, stats, L1 - 1, V)


def _lib():
    lib = _build.load("cat_hist")
    if not getattr(lib, "_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.cat_hist_cls_launch.argtypes = [p] * 4 + [i] * 6 + [p, p]
        lib.cat_hist_cls_launch.restype = i
        lib.cat_hist_reg_launch.argtypes = ([p] * 4 + [i] * 5 + [d] * 3
                                            + [p, p, p])
        lib.cat_hist_reg_launch.restype = i
        lib.cat_hist_max_trees.restype = i
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


def fixed_point_scales(leaf, w, y, L1):
    """One power-of-two scale per regression stat channel: the largest that
    keeps n · max|stat| · scale below 2^61, so no int64 sum can overflow."""
    n = leaf.shape[-1]
    inb = (w > 0) & (leaf > 0) & (leaf < L1)
    wy = w * y
    mags = torch.stack([torch.where(inb, w, 0.0).abs().amax(),
                        torch.where(inb, wy, 0.0).abs().amax(),
                        torch.where(inb, wy * y, 0.0).abs().amax()]).tolist()
    n_bits = max(1, math.ceil(math.log2(max(n, 2))))
    scales = []
    for mag in mags:
        e = 0 if not mag > 0 else 61 - n_bits - math.frexp(mag)[1]
        scales.append(2.0 ** max(-1000, min(1000, e)))
    return scales


def cat_hist(x, leaf, w, y, *, L1, V, num_stats, task="classification"):
    """Count tables (T, m, L1, V, S): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return cat_hist_plain(x, leaf, w, y, L1=L1, V=V,
                              num_stats=num_stats, task=task)
    if x.device.type != "cuda":
        raise ValueError(f"cat_hist runs on CUDA or CPU, not {x.device}")
    _check_inputs(x, leaf, w, y)
    if task == "regression" and num_stats != 3:
        raise ValueError("cat_hist: regression has 3 stats per row")
    T, n = leaf.shape
    m = x.shape[0]
    S = num_stats
    lib = _lib()
    group = lib.cat_hist_max_trees()
    dev = x.device
    out = torch.zeros((T, m, L1, V, S), dtype=torch.float32, device=dev)
    scales = (fixed_point_scales(leaf, w, y, L1) if task == "regression"
              else None)
    P = _build.ptr
    global launches
    for t0 in range(0, T, group):
        t1 = min(T, t0 + group)
        lf, ww = leaf[t0:t1], w[t0:t1]
        if task == "classification":
            err = lib.cat_hist_cls_launch(
                P(x), P(lf), P(ww), P(y), t1 - t0, m, n, L1, V, S,
                P(out[t0:t1]), _build.stream_ptr(dev))
        else:
            acc = torch.zeros((t1 - t0, m, L1, V, S), dtype=torch.int64,
                              device=dev)
            err = lib.cat_hist_reg_launch(
                P(x), P(lf), P(ww), P(y), t1 - t0, m, n, L1, V, *scales,
                P(acc), P(out[t0:t1]), _build.stream_ptr(dev))
        _build.check(err, "cat_hist launch")
        launches += 1
    return out


def bound_bytes(T: int, m: int, n: int, L1: int, V: int, S: int) -> int:
    """Bytes cat_hist must move: each input read once, the table written."""
    return m * n * 4 + T * n * 8 + n * 4 + T * m * L1 * V * S * 4
