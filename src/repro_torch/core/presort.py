"""Presorting of numerical attributes (paper §2.1) and the hist-mode
quantizer, ported from `repro.core.presort`: in memory on torch tensors,
and chunk by chunk on host numpy for out-of-core sources.  Done once per
forest; every tree and every level reuses it.
"""
from __future__ import annotations

import numpy as np
import torch


def presort_columns(num: torch.Tensor) -> torch.Tensor:
    """argsort each numerical column.

    num (n, m_num) float32 -> (m_num, n) int32 row indices in increasing
    value order, stable: ties keep the original row order, as the
    reference's `jnp.argsort(..., stable=True)` does.
    """
    return torch.argsort(num.t(), dim=-1, stable=True).to(
        torch.int32).contiguous()


def gather_sorted(num: torch.Tensor, sorted_idx: torch.Tensor) -> torch.Tensor:
    """Materialize the sorted values: (m_num, n) float32."""
    return torch.gather(num.t(), 1, sorted_idx.long()).contiguous()


# ---------------------------------------------------------------------------
# Histogram (PLANET-style) mode: the bit-packed bin cache
# ---------------------------------------------------------------------------
#
# `split_mode="hist"` buckets each numeric column ONCE into <= num_bins
# equi-depth buckets whose upper edges double as thresholds: the bucket of
# x is the number of lower edges strictly below x, so `bin <= b` and
# `x <= edges[b]` pick the same rows, at training and at inference.

def quantize_edges(sorted_vals: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Per-column bucket upper edges (m_num, B) from the presorted values:
    edges[j, b] is the value at quantile position (b+1)·n//B − 1, so
    edges[j, B-1] is the column max.  Duplicate edges (ties, constant
    columns) leave empty buckets, whose cuts score zero and never win."""
    n = sorted_vals.shape[1]
    pos = (torch.arange(1, num_bins + 1, device=sorted_vals.device) * n
           ) // num_bins - 1
    return sorted_vals[:, pos.clamp(0, n - 1)].contiguous()


def bin_dtype(num_bins: int) -> torch.dtype:
    """The bit-packed bucket-id dtype: uint8 up to 256 buckets, uint16
    past that."""
    return torch.uint8 if num_bins <= 256 else torch.uint16


def bin_ids(bins: torch.Tensor) -> torch.Tensor:
    """Bucket ids as int32.  uint16 is read through its int16 view, which
    every PyTorch operator takes on every device."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16).to(torch.int32) & 0xFFFF
    return bins.to(torch.int32)


def bin_columns(num: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bucket id per row per column: (n, m_num) values -> (m_num, n)
    packed (`bin_dtype`), searchsorted(edges[j, :-1], x, side="left"):
    the first bucket whose upper edge is >= x; values above the column max
    land in the last bucket."""
    ids = torch.searchsorted(edges[:, :-1].contiguous(),
                             num.t().contiguous(), side="left",
                             out_int32=True)
    if bin_dtype(edges.shape[1]) == torch.uint8:
        return ids.to(torch.uint8)
    return ids.to(torch.int16).view(torch.uint16)   # same bits, ids < 2^16


def quantize(num: torch.Tensor, sorted_vals: torch.Tensor,
             num_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The hist-mode bucket state from an existing presort: (bin_of
    (m_num, n) uint8/uint16, edges (m_num, num_bins) float32).  `bin_of`
    is the device-resident cache every hist level reads; `edges` only
    decode winning cut indices into thresholds on the host."""
    edges = quantize_edges(sorted_vals, num_bins)
    return bin_columns(num, edges), edges


# ---------------------------------------------------------------------------
# Chunked (out-of-core) quantization, host numpy
# ---------------------------------------------------------------------------
#
# `quantize_edges` reads fully presorted columns.  For a dataset that never
# fits in memory the same order-statistic edges come from a radix select
# over chunked column blocks: float32 values map to order-preserving uint32
# keys, pass 1 counts the top 16 key bits per column, and two passes of 8
# bits each narrow only the prefixes some quantile still needs.  Three
# passes over the data, O(m · B) state, and edges bit-equal to
# `quantize_edges` on the presort.  NaN is not supported; a column mixing
# -0.0 and +0.0 exactly at a quantile position may differ in the sign of
# that zero edge (the values compare equal, so the bins agree).

_KEY_GROUPS = (16, 8, 8)            # bit-group widths, high to low


def _float_keys(block: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 keys of a float32 block (same shape)."""
    b = np.ascontiguousarray(block, np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b ^ 0x80000000).astype(np.uint32)


def _keys_to_float(keys: np.ndarray) -> np.ndarray:
    """The inverse of `_float_keys`."""
    k = np.asarray(keys, np.uint32)
    b = np.where(k & 0x80000000, k ^ 0x80000000, ~k).astype(np.uint32)
    return b.view(np.float32)


def streaming_quantile_edges(chunks, n: int, m_num: int,
                             num_bins: int) -> np.ndarray:
    """Exact per-column quantile edges from chunked row blocks.

    chunks: a callable returning a fresh iterator of (c, m_num) float32 row
    blocks that cover the n rows (called once per pass, three times).
    Returns edges (m_num, num_bins) float32, bit-equal to
    `quantize_edges(gather_sorted(num, presort_columns(num)), num_bins)`:
    the values at positions clip((b + 1)·n // B − 1, 0, n − 1).
    """
    if n <= 0 or m_num <= 0:
        raise ValueError(f"need rows and columns, got n={n}, m_num={m_num}")
    pos = (np.arange(1, num_bins + 1, dtype=np.int64) * n) // num_bins - 1
    pos = np.clip(pos, 0, n - 1)
    rank = np.broadcast_to(pos + 1, (m_num, num_bins)).astype(np.int64)
    pref = np.zeros((m_num, num_bins), np.int64)   # resolved high key bits
    done = 0
    for g, width in enumerate(_KEY_GROUPS):
        shift = 32 - done - width
        size = 1 << width
        if g == 0:
            counts = np.zeros((m_num, size), np.int64)
            for block in chunks():
                keys = _float_keys(block) >> np.uint32(shift)
                for j in range(m_num):
                    counts[j] += np.bincount(keys[:, j], minlength=size)
            for j in range(m_num):
                cum = np.cumsum(counts[j])
                gsel = np.searchsorted(cum, rank[j], side="left")
                rank[j] -= np.where(gsel > 0, cum[gsel - 1], 0)
                pref[j] = gsel
        else:
            # refine only the prefixes some quantile still needs
            uniq = [np.unique(pref[j]) for j in range(m_num)]
            P = max(len(u) for u in uniq)
            counts = np.zeros((m_num, P, size), np.int64)
            mask = size - 1
            for block in chunks():
                keys = _float_keys(block)
                hi = keys >> np.uint32(shift + width)
                sub = (keys >> np.uint32(shift)).astype(np.int64) & mask
                for j in range(m_num):
                    u = uniq[j]
                    idx = np.minimum(np.searchsorted(u, hi[:, j]), len(u) - 1)
                    match = u[idx] == hi[:, j]
                    flat = idx[match] * size + sub[:, j][match]
                    counts[j] += np.bincount(
                        flat, minlength=P * size).reshape(P, size)
            for j in range(m_num):
                pi = np.searchsorted(uniq[j], pref[j])
                cum = np.cumsum(counts[j], axis=1)[pi]          # (B, size)
                gsel = (cum < rank[j][:, None]).sum(1)
                before = np.where(gsel > 0,
                                  cum[np.arange(num_bins), gsel - 1], 0)
                rank[j] -= before
                pref[j] = (pref[j] << width) | gsel
        done += width
    return _keys_to_float(pref.astype(np.uint32))


def bin_block(block: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Host chunk binning: (c, m_num) float32 -> (m_num, c) packed ids.

    The numpy twin of `bin_columns`: the same rule
    (`searchsorted(edges[j, :-1], x, side="left")`, values above the column
    max in the last bucket) and the same packing, so a chunk-binned cache
    is bit-equal to the in-memory one.
    """
    m_num, B = edges.shape
    out = np.empty((m_num, block.shape[0]), np.uint8 if B <= 256
                   else np.uint16)
    for j in range(m_num):
        out[j] = np.searchsorted(edges[j, :-1], block[:, j], side="left")
    return out
