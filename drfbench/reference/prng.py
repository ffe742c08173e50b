"""A frozen copy of the counter-based generator that defines a forest's
random draws: JAX's threefry2x32 under `jax_threefry_partitionable=True`.

The forest's bag counts and candidate features are pure functions of
`(forest seed, tree index)` (paper §2.2), drawn from this generator, so
the reference re-derives them here instead of taking them from the
program.  Keys are int64 tensors `(..., 2)` of two uint32 words; uint32
arithmetic runs in int64 with `& 0xFFFFFFFF`, on the key's device.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (key word added to x0, key word added to x1, round constant) per block
_INJECT = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) on broadcastable int64 uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & MASK
    x1 = (x1 + k2) & MASK
    for i, (a, b, c) in enumerate(_INJECT):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[a]) & MASK
        x1 = (x1 + ks[b] + c) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: key (..., 2), data broadcastable -> (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: (..., 2) -> (..., num, 2)."""
    return fold_in(key[..., None, :],
                   torch.arange(num, dtype=torch.int64, device=key.device))


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element: key (..., 2) -> (..., *shape) int64."""
    size = math.prod(shape)
    counts = torch.arange(size, dtype=torch.int64,
                          device=key.device).reshape(shape)
    expand = (...,) + (None,) * len(shape)
    y0, y1 = threefry2x32(key[..., 0][expand], key[..., 1][expand],
                          torch.zeros_like(counts), counts)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`jax.random.uniform` in float32 from the top 23 random bits."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def poisson_knuth(key: torch.Tensor, lam: float, shape: tuple) -> torch.Tensor:
    """`jax.random.poisson(key, lam, shape)` for lam < 10 (Knuth's loop):
    every iteration splits the key and adds the log of a fresh uniform
    to each element still above -lam.  Leading key dimensions batch."""
    out_shape = key.shape[:-1] + tuple(shape)
    k = torch.zeros(out_shape, dtype=torch.int32, device=key.device)
    log_prod = torch.zeros(out_shape, dtype=torch.float32, device=key.device)
    neg_lam = torch.tensor(-lam, dtype=torch.float32, device=key.device)
    rng = key
    while True:
        live = log_prod > neg_lam
        if not bool(live.any()):
            break
        keys = split(rng)
        rng, sub = keys[..., 0, :], keys[..., 1, :]
        k = torch.where(live, k + 1, k)
        log_prod = log_prod + torch.log(uniform(sub, tuple(shape)))
    return k - 1
