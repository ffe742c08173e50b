"""Presorting of numerical attributes (paper §2.1) and the hist-mode
quantizer, ported from `repro.core.presort` (in memory; the streaming
quantizer is a later slice).  Done once per forest; every tree and every
level reuses it.
"""
from __future__ import annotations

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
