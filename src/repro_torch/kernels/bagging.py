"""Poisson(1) bag counts (paper §2.2): the CUDA kernel and its plain
version.

Replaces no TPU kernel: the reference draws its bags with
`jax.random.poisson` (plain XLA), which `prng.poisson_knuth` copies bit
for bit as a batched torch loop.  Contract, for a batch of T trees:

    key (2,) int64 on the CPU    the forest's base key, `prng.prng_key(seed)`
    tree_indices                 T tree indices (ints)
    n                            rows a tree, 0 <= n < 2^32
    -> (T, n) float32 on `device`: row t is `jax.random.poisson(
       fold_in(key, tree_indices[t]), 1.0, (n,))`, as float32

CUDA source: `repro_torch/csrc/bagging.cu`, which states the bound and the
design: a thread runs Knuth's loop for one (tree, row) element at a time,
from a per-block table of the key chain's subkeys.  `poisson` launches it
for a CUDA device and takes the plain version only for the CPU; the counts
are bit-equal.  The key's words are read on the host and the tree indices
travel in the launch's parameters, so the draw queues one launch a batch
of up to 256 trees and waits on nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import prng
from repro_torch.kernels import _build

MAX_ROWS = 1 << 32          # rows a tree: the counter's 32-bit row word
UNIFORMS = 1 << 23          # the uniforms a draw can give: k·2^-23

launches = 0                # wrapper calls that launched the kernel
rows = 0                    # (tree, row) counts they drew


def poisson_plain(key: torch.Tensor, tree_indices, n: int,
                  device=None) -> torch.Tensor:
    """The plain torch version: `prng.poisson_knuth` on the trees' keys."""
    key = key.to(device)
    tidx = torch.as_tensor(list(tree_indices), dtype=torch.int64,
                           device=key.device)
    keys = prng.fold_in(key[None, :], tidx)
    return prng.poisson_knuth(keys, 1.0, (n,)).to(torch.float32)


def _lib():
    lib = _build.load("bagging")
    if not getattr(lib, "_typed", False):
        p, u, ll = ctypes.c_void_p, ctypes.c_uint, ctypes.c_longlong
        lib.bag_poisson_launch.argtypes = [u, u, p, ctypes.c_int, ll, p, p]
        lib.bag_poisson_launch.restype = ctypes.c_int
        lib.bag_uniform_log.argtypes = [p, p]
        lib.bag_uniform_log.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_inputs(key, n, device):
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise ValueError(f"bagging: key must be int64 (2,), got {key.dtype} "
                         f"{tuple(key.shape)}")
    if key.device.type != "cpu":
        raise ValueError(f"bagging: the key's words are read on the host; "
                         f"it lies on {key.device}")
    if not 0 <= n < MAX_ROWS:
        raise ValueError(f"bagging: {n} rows a tree; draws of 2**32 or more "
                         f"elements are not supported")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"bagging runs on CUDA or CPU, not {device}")


def poisson(key: torch.Tensor, tree_indices, n: int,
            device=None) -> torch.Tensor:
    """Poisson(1) bag counts (T, n) float32 of `tree_indices` on `device`.

    A CUDA device launches the kernel; the CPU takes the plain version.
    """
    device = torch.device("cpu" if device is None else device)
    _check_inputs(key, n, device)
    tidx = [int(t) for t in tree_indices]
    if device.type == "cpu":
        return poisson_plain(key, tidx, n, device)
    T = len(tidx)
    out = torch.empty((T, n), dtype=torch.float32, device=device)
    if T == 0 or n == 0:
        return out
    k0, k1 = (int(w) & prng.MASK for w in key.tolist())
    words = (ctypes.c_uint * T)(*(t & prng.MASK for t in tidx))
    err = _lib().bag_poisson_launch(k0, k1, words, T, n, _build.ptr(out),
                                    _build.stream_ptr(out.device))
    _build.check(err, "bagging launch")
    global launches, rows
    launches += 1
    rows += T * n
    return out


def uniform_log(device) -> torch.Tensor:
    """The kernel's log of every uniform it can draw: (2^23,) float32 on a
    CUDA device, entry k the log of k·2^-23 (for a check against
    `torch.log`)."""
    out = torch.empty(UNIFORMS, dtype=torch.float32, device=device)
    _build.check(_lib().bag_uniform_log(_build.ptr(out),
                                        _build.stream_ptr(out.device)),
                 "bagging uniform_log")
    return out


def bound_bytes(T: int, n: int) -> int:
    """Bytes the kernel must move: the (T, n) float32 counts written."""
    return 4 * T * n


def bound_int_ops(passes: int) -> int:
    """32-bit integer operations the draw needs: for every pass of every
    row (`passes` = the sum over the rows of count + 1), one Threefry (20
    rounds of an add, a rotation and an xor; five key injections of three
    adds; the first two adds) and the uniform's xor, shift and or."""
    return passes * (20 * 3 + 5 * 3 + 2 + 3)
