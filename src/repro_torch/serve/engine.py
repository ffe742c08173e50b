"""Serving, ported from `repro.serve.engine`: the forest inference server
(`ForestServer`) and the LM half (`prefill_step`, `decode_step`,
`greedy_sample`, `BatchedServer`).

`ForestServer` is a long-lived process's view of ONE versioned
`PackedForest` .npz (`forest.PackedForest.save`, written by either
package): `load` puts its arrays on the device and runs one batch per
warm size there, so the first real request pays no CUDA context, module
load or allocator growth; `predict` validates each request on the host
and answers it with one descent of every tree (`forest._forest_predict`).

The LM functions take a `models.transformer.Transformer` (its device is
the model's).  `BatchedServer` mirrors the reference's server step for
step, including two of its behaviours that a production server would not
share: `add_request` prefills through decode steps over the WHOLE batch
(token 0 in every other slot, which leaves attention caches as they were
but advances the other active slots' RWKV and Mamba states), and the
first `step` after a prefill feeds token 0 to a slot that has no output
yet.  Its token streams are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.forest import PackedForest
from repro_torch.models import transformer


class InvalidRequest(ValueError):
    """A malformed predict request.

    Raised by `ForestServer.predict` before anything reaches the device,
    for wrong-shape inputs, non-finite numeric rows, or categorical ids
    outside the declared arity: the cases that would otherwise crash out
    of the serving loop or silently route every row down a wrong path.
    The server holds no per-request state, so catching this and answering
    the client with an error leaves it serving."""


@dataclasses.dataclass
class ForestServer:
    """Low-latency inference server over an exported `PackedForest`.

    Usage:
        srv = ForestServer.load("model.npz", m_cat=2)   # load + warm
        probs = srv.predict(num_rows, cat_rows)          # (B, C) tensor

    `predict` returns the forest-mean distributions as a float32 tensor on
    the server's device (`PackedForest.predict_proba`).
    """

    packed: PackedForest
    m_cat: int = 0
    arities: Optional[tuple] = None     # per categorical column, if known

    @classmethod
    def load(cls, path, m_cat: int = 0, warm_batch_sizes=(1,), arities=None,
             device=None) -> "ForestServer":
        """Load an exported forest onto `device` and warm it.

        `m_cat` is the categorical input width requests will carry (the
        .npz stores only the model; 0 for all-numeric forests).
        `warm_batch_sizes` are the request shapes run once at load (1
        covers the single-row latency path).  `arities` (optional, len
        m_cat) enables per-column range checks on categorical ids: an id
        past its column's arity raises `InvalidRequest` instead of reading
        the split mask at a wrong category.  `device`: None means CUDA and
        raises without a GPU; "cpu" serves from the host.
        """
        packed = PackedForest.load(path, device=device)
        if arities is not None:
            arities = tuple(int(a) for a in arities)
            if len(arities) != int(m_cat):
                raise ValueError(
                    f"arities has {len(arities)} entries but m_cat="
                    f"{int(m_cat)} — pass one arity per categorical "
                    f"column")
        srv = cls(packed=packed, m_cat=int(m_cat), arities=arities)
        if srv._needs_cat() and srv.m_cat == 0:
            raise ValueError(
                "this forest splits on categorical features but the "
                "server was loaded with m_cat=0 — pass the dataset's "
                "categorical column count to ForestServer.load(path, "
                "m_cat=...) so requests carry the categorical row")
        for b in warm_batch_sizes:
            srv.predict(np.zeros((b, packed.m_num), np.float32),
                        np.zeros((b, srv.m_cat), np.int32))
        if packed.device.type == "cuda":
            torch.cuda.synchronize(packed.device)
        return srv

    def _needs_cat(self) -> bool:
        return bool(self.packed.is_cat.any())

    def _validate(self, num: np.ndarray, cat) -> np.ndarray:
        """Reject malformed requests with `InvalidRequest` (typed, safe
        to catch-and-answer) before anything reaches the device."""
        if num.ndim != 2 or num.shape[1] != self.packed.m_num:
            raise InvalidRequest(
                f"numeric input must be (B, {self.packed.m_num}), got "
                f"shape {tuple(num.shape)}")
        if num.size and not np.isfinite(num).all():
            bad = np.argwhere(~np.isfinite(num))[0]
            raise InvalidRequest(
                f"numeric input contains a non-finite value at row "
                f"{int(bad[0])}, column {int(bad[1])} — NaN/inf would "
                f"route every comparison to the right child silently")
        if cat is None:
            if self.m_cat:
                raise InvalidRequest(
                    f"this server was loaded with m_cat={self.m_cat}: "
                    "every request must carry a (B, m_cat) categorical "
                    "array (an empty one would silently route every "
                    "categorical split by category 0)")
            return np.zeros((num.shape[0], 0), np.int32)
        cat = np.asarray(cat)
        if not np.issubdtype(cat.dtype, np.integer):
            raise InvalidRequest(
                f"categorical input must be integer ids, got dtype "
                f"{cat.dtype}")
        if cat.ndim != 2 or cat.shape[1] != self.m_cat:
            raise InvalidRequest(
                f"categorical input must be (B, {self.m_cat}), got "
                f"shape {tuple(cat.shape)}")
        if cat.shape != (num.shape[0], self.m_cat):
            raise InvalidRequest(
                f"categorical batch {cat.shape[0]} != numeric batch "
                f"{num.shape[0]}")
        if cat.size:
            if cat.min() < 0:
                raise InvalidRequest("categorical ids must be >= 0")
            if self.arities is not None:
                hi = cat.max(axis=0)
                for j, a in enumerate(self.arities):
                    if int(hi[j]) >= a:
                        raise InvalidRequest(
                            f"categorical column {j} has id "
                            f"{int(hi[j])} but arity {a} (valid ids "
                            f"0..{a - 1})")
        return cat.astype(np.int32, copy=False)

    def predict(self, num, cat=None) -> torch.Tensor:
        """(B, C) forest-mean distributions, one descent of every tree.

        Malformed requests raise `InvalidRequest` before the descent: the
        caller answers the client and keeps serving."""
        num = np.asarray(num, np.float32)
        cat = self._validate(num, cat)
        return self.packed.predict_proba(torch.from_numpy(num),
                                         torch.from_numpy(cat))


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------

def prefill_step(model, inputs):
    """Full-sequence forward; returns (last-position logits (B,1,V), layer
    caches).  Only the final position is projected: the sampler reads one
    position, and the (B, S, vocab) tensor would be pure waste."""
    x, _, caches = model.forward_hidden(inputs, collect_cache=True)
    return model.project_logits(x[:, -1:]), caches


def decode_step(model, caches, inputs, cache_len):
    """One new token against a max_seq cache (updated in place)."""
    return model.decode_step(caches, inputs, cache_len)


def greedy_sample(logits):
    return torch.argmax(logits[:, -1], dim=-1)


@dataclasses.dataclass
class BatchedServer:
    """Minimal batched continuous-decode server.

    Holds a fixed-size batch of slots; each slot has a cache position.  New
    requests prefill into a free slot; every `step()` decodes one token for
    all active slots.  See the module docstring for the two behaviours it
    keeps from the reference.
    """
    model: transformer.Transformer
    max_seq: int
    batch: int

    def __post_init__(self):
        dev = self.model.device
        self.caches = transformer.init_cache(self.model.cfg, self.batch,
                                             self.max_seq, dev)
        self.lens = torch.zeros(self.batch, dtype=torch.int64, device=dev)
        self.active = [False] * self.batch
        self.outputs: list[list[int]] = [[] for _ in range(self.batch)]

    def add_request(self, prompt_tokens) -> int:
        slot = self.active.index(False)
        # sequential prefill through decode steps over the whole batch
        for t in [int(t) for t in prompt_tokens]:
            tok = torch.zeros(self.batch, 1, dtype=torch.int64,
                              device=self.model.device)
            tok[slot, 0] = t
            _, self.caches = self.model.decode_step(self.caches, tok,
                                                    self.lens)
            self.lens[slot] += 1
        self.active[slot] = True
        return slot

    def step(self) -> dict[int, int]:
        """Decode one token for every active slot; returns {slot: token}."""
        last = torch.tensor(
            [self.outputs[i][-1] if self.outputs[i] else 0
             for i in range(self.batch)], dtype=torch.int64,
            device=self.model.device)[:, None]
        logits, self.caches = self.model.decode_step(self.caches, last,
                                                     self.lens)
        nxt = torch.argmax(logits[:, 0], dim=-1).tolist()
        out = {}
        for i in range(self.batch):
            if self.active[i]:
                self.outputs[i].append(nxt[i])
                self.lens[i] += 1
                out[i] = nxt[i]
        return out

    def finish(self, slot: int) -> list[int]:
        self.active[slot] = False
        toks, self.outputs[slot] = self.outputs[slot], []
        self.lens[slot] = 0
        return toks
