"""Deterministic seeded bagging (paper §2.2), ported from `repro.core.bagging`.

All workers derive the identical per-sample bag counts and per-leaf
candidate features from `(forest_seed, tree_index)` alone — zero bytes on
the wire.  The draws come from the port's copy of the reference's
threefry generator (`core/prng.py`), so they equal the reference's draws
bit for bit and the port grows the same trees.

Modes: "poisson" (independent Poisson(1) counts, the default),
"multinomial" (n-out-of-n sampling with replacement, the paper's stated
scheme: n uniform row draws, counted) and "none" (weight 1 everywhere).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng


def _base_key(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor) and seed.ndim:
        return seed.to(device)
    return prng.prng_key(int(seed), device)


def bag_counts(seed, tree_idx: int, n: int, mode: str = "poisson",
               device=None) -> torch.Tensor:
    """Per-sample bag multiplicity for one tree: (n,) float32."""
    return bag_counts_forest(seed, [tree_idx], n, mode, device)[0]


def bag_counts_forest(seed, tree_indices, n: int, mode: str = "poisson",
                      device=None) -> torch.Tensor:
    """`bag_counts` for a batch of trees at once: (T, n) float32.

    Row t equals `bag_counts(seed, tree_indices[t], n, mode)` bit for bit:
    the fold-in chain is elementwise, so batching draws nothing extra.
    """
    tidx = torch.as_tensor(list(tree_indices), dtype=torch.int64,
                           device=device)
    if mode == "poisson":
        keys = prng.fold_in(_base_key(seed, device)[None, :], tidx)
        return prng.poisson_knuth(keys, 1.0, (n,)).to(torch.float32)
    if mode == "none":
        return torch.ones((len(tidx), n), dtype=torch.float32, device=device)
    if mode == "multinomial":
        # a row's count is a small integer (far below 2^24), so the
        # float32 cast is exact; the sums over rows are taken in int32
        keys = prng.fold_in(_base_key(seed, device)[None, :], tidx)
        draws = prng.randint(keys, (n,), 0, n)                # (T, n)
        T = len(tidx)
        flat = draws + torch.arange(T, device=draws.device)[:, None] * n
        return torch.bincount(flat.reshape(-1), minlength=T * n).reshape(
            T, n).to(torch.float32)
    raise ValueError(f"unknown bagging mode {mode!r}")


def candidate_features(key: torch.Tensor, depth: int, num_leaves: int,
                       m: int, m_prime: int, usb: bool = False) -> torch.Tensor:
    """Per-leaf candidate feature masks (paper §2.4; §3.2 USB).

    key (..., 2) -> (..., num_leaves, m) bool, True where feature j is a
    candidate for leaf row h.  A leading key dimension (the tree axis)
    batches.  Padding-independent like the reference: row h folds its own
    index into the (key, depth) key, so it never depends on `num_leaves`.
    The m' largest uniforms win; ties go to the lower feature index, as
    XLA's TopK orders them, hence a stable descending sort (not
    `torch.topk`, whose tie order is unspecified).
    """
    key = prng.fold_in(key, depth)
    z = 1 if usb else num_leaves
    leaf_keys = prng.fold_in(key[..., None, :],
                             torch.arange(z, dtype=torch.int64,
                                          device=key.device))
    g = prng.uniform(leaf_keys, (m,))                         # (..., z, m)
    idx = torch.sort(g, dim=-1, descending=True, stable=True).indices
    mask = torch.zeros(g.shape, dtype=torch.bool, device=key.device)
    mask.scatter_(-1, idx[..., :m_prime], True)
    if usb:
        mask = mask.expand(*mask.shape[:-2], num_leaves, m)
    return mask
