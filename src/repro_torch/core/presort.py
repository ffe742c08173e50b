"""Presorting of numerical attributes (paper §2.1), ported from
`repro.core.presort` (exact mode only; the hist-mode quantizer is a later
slice).  Done once per forest; every tree and every level reuses it.
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
