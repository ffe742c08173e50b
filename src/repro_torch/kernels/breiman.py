"""Breiman scoring of categorical count tables (paper §2.4): the CUDA
kernel and its plain version.

Replaces no TPU kernel: the reference scores its tables with plain jnp
(`splits.best_categorical_split_from_table`).  Contract, for a batch of T
trees over m categorical columns:

    tables (T, m, L1, V, S) i32   class counts per (tree, column, leaf,
                                  category), S >= 2 classes
    cand   (T, m, L1) bool        candidate columns of each leaf
    -> gains (T, m, L1) f32, masks (T, m, L1, V) bool (True = LEFT): the
       first best of the V − 1 prefix cuts of the categories ordered by
       P(last class | v), empty ones last, both sides >= min_records

CUDA source: `repro_torch/csrc/breiman.cu`, which states the bound and the
design: a block walks a few segments (tree, column, leaf), skips those that
are not candidates, and sorts and scans only the categories that hold rows.
`breiman` launches it for CUDA tensors, at any V and any number of classes
S, and takes the plain version only for CPU tensors.  Both sum the counts
as integers (exact to 2^31) and convert each sum to float32 once for the
metric and the gains.  Gains are bit-equal to the plain version's on the
card (integer counts, the same operation order, the classes added in the
order of torch's CUDA sum); wherever the gain is finite the masks are
equal.  A segment with no valid cut gets −inf and, from the kernel, an
all-False mask (the plain version flags its first category); the level
plan reads no mask whose gain is −inf.  Besides the
two outputs the wrapper allocates a workspace only where S > 16 (a
thread's class vectors) or V is too wide for one block's shared memory to
hold V sort keys (about 25,000 categories): as many slices as blocks are
resident at once.

Regression tables are scored by `breiman_plain` on every device: their
prefix sums are float64 in a fixed order (`splits._prefix_cuts`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import splits
from repro_torch.kernels import _build

IMPURITY = {"gini": 0, "entropy": 1}
# The plain version scores column chunks whose tables stay below this many
# float32 elements, bounding its sort and cumsum temporaries.
CHUNK_ELEMS = 1 << 27

launches = 0                # kernel launches (one per wrapper call)
segments = 0                # (tree, column, leaf) segments launched over
_scored = {}                # device -> int64 count of candidate segments


def breiman_plain(tables, cand, *, impurity="gini", task="classification",
                  min_records=1.0):
    """The plain torch version: `splits.best_categorical_split_from_table`
    over column chunks of at most CHUNK_ELEMS table elements."""
    T, m, L1, V, S = tables.shape
    step = max(1, CHUNK_ELEMS // max(1, T * L1 * V * S))
    gains = torch.empty((T, m, L1), dtype=torch.float32,
                        device=tables.device)
    masks = torch.empty((T, m, L1, V), dtype=torch.bool,
                        device=tables.device)
    for j0 in range(0, m, step):
        j1 = min(m, j0 + step)
        gains[:, j0:j1], masks[:, j0:j1] = \
            splits.best_categorical_split_from_table(
                tables[:, j0:j1], cand[:, j0:j1], impurity, task,
                min_records)
    return gains, masks


def _lib():
    lib = _build.load("breiman")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.brm_launch.argtypes = [p, p, ll, i, i, i, ctypes.c_float,
                                   p, p, p, p, ll, p]
        lib.brm_launch.restype = i
        lib.brm_workspace_bytes.argtypes = [ll, i, i]
        lib.brm_workspace_bytes.restype = ll
        lib._typed = True
    return lib


def _check_inputs(tables, cand):
    if tables.dtype != torch.int32 or tables.dim() != 5:
        raise ValueError(f"breiman: tables must be int32 (T, m, L1, V, S), "
                         f"got {tables.dtype} {tuple(tables.shape)}")
    if cand.dtype != torch.bool or tuple(cand.shape) != tuple(
            tables.shape[:3]):
        raise ValueError(f"breiman: cand must be bool {tuple(tables.shape[:3])}"
                         f", got {cand.dtype} {tuple(cand.shape)}")
    for name, t in (("tables", tables), ("cand", cand)):
        if not t.is_contiguous():
            raise ValueError(f"breiman: {name} must be contiguous")
    if cand.device != tables.device:
        raise ValueError(f"breiman: cand is on {cand.device}, tables on "
                         f"{tables.device}")


def scored_counter(device) -> torch.Tensor:
    """The device's int64 count of candidate segments the kernel scored
    (added to by every launch, never reset; reading it syncs)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _scored:
        _scored[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _scored[device]


def breiman(tables, cand, *, impurity="gini", min_records=1.0):
    """Best Breiman split per (tree, column, leaf) of classification count
    tables: (gains (T, m, L1), masks (T, m, L1, V)).

    CUDA tensors launch the kernel, which takes int32 counts only (as
    `cat_hist` gives them); CPU tensors take the plain version.
    """
    if tables.device.type == "cpu":
        return breiman_plain(tables, cand, impurity=impurity,
                             min_records=min_records)
    if tables.device.type != "cuda":
        raise ValueError(f"breiman runs on CUDA or CPU, not {tables.device}")
    _check_inputs(tables, cand)
    if impurity not in IMPURITY:
        raise ValueError(f"breiman scores gini or entropy, not {impurity!r}")
    T, m, L1, V, S = tables.shape
    dev = tables.device
    gains = torch.empty((T, m, L1), dtype=torch.float32, device=dev)
    masks = torch.empty((T, m, L1, V), dtype=torch.bool, device=dev)
    nseg = T * m * L1
    if nseg == 0 or V == 0:
        masks.zero_()
        return gains.fill_(splits.NEG), masks
    lib = _lib()
    ws_bytes = lib.brm_workspace_bytes(nseg, V, S)
    if ws_bytes < 0:
        raise RuntimeError(f"breiman: no launch plan for {nseg} segments, "
                           f"V = {V}, S = {S} on {dev}")
    ws = (torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
          if ws_bytes else None)
    P = _build.ptr
    err = lib.brm_launch(
        P(tables), P(cand.view(torch.uint8)), nseg, V, S,
        IMPURITY[impurity], float(min_records), P(scored_counter(dev)),
        P(gains), P(masks.view(torch.uint8)),
        P(ws) if ws is not None else None, ws_bytes,
        _build.stream_ptr(dev))
    _build.check(err, "breiman launch")
    global launches, segments
    launches += 1
    segments += nseg
    return gains, masks


def bound_bytes(n_cand: int, T: int, m: int, L1: int, V: int, S: int) -> int:
    """Bytes the kernel must move: the candidate segments' counts read
    once, every segment's candidate flag read and gain and mask row
    written."""
    return n_cand * V * S * 4 + T * m * L1 * (1 + 4 + V)
