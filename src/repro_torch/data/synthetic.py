"""Synthetic datasets, ported from `repro.data.synthetic`.

The tabular families follow the paper's §4 artificial benchmark (xor,
majority, needle ground truths with informative + useless variables).
The LM side is `TokenStream`, an infinite deterministic token stream for
the training path.  numpy only, drawn from the same seeds as the
reference, so both packages train on identical data.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dataset import TabularDataset, from_numpy


def make_tabular(family: str, n: int, num_informative: int = 8,
                 num_useless: int = 8, num_categorical: int = 0,
                 seed: int = 0) -> TabularDataset:
    """family: xor | majority | needle | linear."""
    rng = np.random.default_rng(seed)
    m = num_informative + num_useless
    num = rng.normal(size=(n, m)).astype(np.float32)
    inf = num[:, :num_informative]
    if family == "xor":
        y = ((inf > 0).sum(1) % 2).astype(np.int32)
    elif family == "majority":
        y = ((inf > 0).sum(1) > num_informative / 2).astype(np.int32)
    elif family == "needle":
        y = ((inf > 0).all(1)).astype(np.int32)
    elif family == "linear":
        w = rng.normal(size=num_informative)
        y = (inf @ w > 0).astype(np.int32)
    else:
        raise ValueError(family)
    cat = None
    arities = None
    if num_categorical:
        arities = [int(a) for a in
                   rng.integers(2, 32, size=num_categorical)]
        cat = np.stack([rng.integers(0, a, size=n) for a in arities], axis=1)
        flip = (cat[:, 0] % 2).astype(np.int32)
        y = np.where(rng.random(n) < 0.25, y ^ flip, y).astype(np.int32)
    return from_numpy(num, cat, y, arities)


def train_test_split(ds: TabularDataset, test_frac: float = 0.25,
                     seed: int = 1):
    rng = np.random.default_rng(seed)
    n = ds.n
    perm = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr, te = perm[:cut], perm[cut:]

    def take(idx):
        return from_numpy(ds.num[idx], ds.cat[idx], ds.labels[idx],
                          ds.arities, ds.task)

    return take(tr), take(te)


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------

class TokenStream:
    """Deterministic synthetic LM data: a 2-gram Markov source over `vocab`
    tokens with a learnable structure (so loss visibly decreases).

    The successor table is drawn from `default_rng(seed)` and batch i from
    `default_rng(1000 + i)`, as the reference draws them: both packages
    see the same int32 batches bit for bit."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0):
        self.vocab, self.seq, self.batch = vocab_size, seq_len, batch
        rng = np.random.default_rng(seed)
        k = min(vocab_size, 256)
        self._succ = rng.integers(0, vocab_size, size=(k, 4))
        self._k = k
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng(1000 + self._step)
        self._step += 1
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        for t in range(1, self.seq + 1):
            prev = toks[:, t - 1] % self._k
            choice = rng.integers(0, 4, size=self.batch)
            nxt = self._succ[prev, choice]
            noise = rng.integers(0, self.vocab, size=self.batch)
            use_noise = rng.random(self.batch) < 0.1
            toks[:, t] = np.where(use_noise, noise, nxt)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
