"""The counter-based generator the reference's seeding is defined by.

The reference draws every bag count and candidate feature from JAX's
threefry2x32 generator (paper §2.2: all workers derive identical draws
from `(seed, tree)`), so those draws DEFINE the trees.  This module is the
port's own copy of the pieces the reference uses, bit for bit, under
`jax_threefry_partitionable=True` (the default from jax 0.5 on):

  * `threefry2x32` — the 20-round Threefry-2x32 block function;
  * `prng_key(seed)` — `jax.random.PRNGKey(int)`;
  * `fold_in`, `split` — the partitionable (fold-like) key derivations;
  * `uniform` — float32 in [0, 1) from the top 23 random bits;
  * `randint` — `jax.random.randint` for int32 draws in [lo, hi);
  * `poisson_knuth` — `jax.random.poisson` for rate < 10: Knuth's loop
    (on a CUDA device the bag draw runs `kernels/bagging.py` instead).

A key is an int64 tensor `(..., 2)` holding two uint32 words; uint32
arithmetic runs in int64 with `& 0xFFFFFFFF`, on whatever device the key
lives on.  Leading key dimensions broadcast, which replaces `jax.vmap`.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (key word added to x0, key word added to x1, round constant) per block
_INJECT = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 on broadcastable int64 tensors of uint32 words."""
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
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: the words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _words(key: torch.Tensor):
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: key (..., 2), data int or int tensor
    broadcastable against key[..., 0] -> (..., 2)."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: (..., 2) -> (..., num, 2)."""
    return fold_in(key[..., None, :],
                   torch.arange(num, dtype=torch.int64, device=key.device))


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element: key (..., 2) -> (..., *shape) int64."""
    size = math.prod(shape)
    if size >= 1 << 32:
        raise ValueError("draws of 2**32 or more elements are not supported")
    counts = torch.arange(size, dtype=torch.int64,
                          device=key.device).reshape(shape)
    k1, k2 = _words(key)
    expand = (...,) + (None,) * len(shape)
    y0, y1 = threefry2x32(k1[expand], k2[expand], torch.zeros_like(counts),
                          counts)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in float32: (..., *shape)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` for int32 draws
    (64-bit mode off): (..., *shape) int64 values in [minval, maxval).

    As `jax._src.random._randint` computes it: the key splits in two, each
    half draws 32 random bits per element (higher and lower), and the
    offset is (hi mod span) · (2^32 mod span) + (lo mod span), mod span —
    all uint32 arithmetic that wraps, reproduced here in int64 with masks.
    """
    minval, maxval = int(minval), int(maxval)
    if not (-(1 << 31) <= minval and maxval <= (1 << 31) - 1):
        raise ValueError("randint bounds must fit in int32")
    span = (maxval - minval) & MASK if maxval > minval else 1
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return minval + off % span


def poisson_knuth(key: torch.Tensor, lam: float, shape: tuple) -> torch.Tensor:
    """`jax.random.poisson(key, lam, shape)` for lam < 10, int32.

    Knuth's loop as `jax._src.random._poisson_knuth` runs it: every
    iteration splits the key, counts the elements whose float32 log
    product is still above -lam, and adds the log of a fresh uniform draw.
    Leading key dimensions batch independent draws (a tree axis); the loop
    runs until every element of every draw has finished, which leaves each
    element's count unchanged, exactly as JAX's batched while loop does.
    """
    if not 0.0 < lam < 10.0:
        raise NotImplementedError("only Knuth's branch (0 < lam < 10) is ported")
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
