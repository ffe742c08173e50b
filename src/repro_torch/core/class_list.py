"""Bit-packed sample->leaf mapping (paper §2.3), ported from
`repro.core.class_list`.

The paper's memory bound: ⌈log2(ℓ+1)⌉ bits per sample (open leaves 1..ℓ
plus the closed sentinel 0).  `values_per_word = 32 // bits` ids per 32-bit
word, no word straddling.  Words are held in int64 tensors (torch has no
full uint32 arithmetic); each holds a value below 2**32.
"""
from __future__ import annotations

import math

import torch

CLOSED = 0  # sentinel leaf id


def bits_needed(num_open_leaves: int) -> int:
    """⌈log2(ℓ+1)⌉, minimum 1."""
    return max(1, math.ceil(math.log2(num_open_leaves + 1)))


def pack(leaf_ids: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (n,) leaf ids (< 2**bits) into 32-bit words (int64 tensor)."""
    vpw = 32 // bits
    n = leaf_ids.shape[0]
    ids = torch.nn.functional.pad(leaf_ids.to(torch.int64), (0, (-n) % vpw))
    shifts = torch.arange(vpw, dtype=torch.int64, device=ids.device) * bits
    return (ids.reshape(-1, vpw) << shifts).sum(1)   # disjoint bits: sum == or


def unpack(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of `pack`; returns (n,) int32."""
    vpw = 32 // bits
    shifts = torch.arange(vpw, dtype=torch.int64, device=words.device) * bits
    vals = (words[:, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(-1)[:n].to(torch.int32)


def packed_words(n: int, bits: int) -> int:
    vpw = 32 // bits
    return -(-n // vpw)


def storage_bits(n: int, num_open_leaves: int) -> int:
    """The paper's memory bound for the mapping (reported in LevelStats)."""
    return n * bits_needed(num_open_leaves)
