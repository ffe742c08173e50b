"""Tabular dataset container (paper §2.1), ported from `repro.core.dataset`.

The paper's datasets mix numerical and categorical columns (Leo: 3
numerical + 69 categorical, arities 2..10'000).  The two groups live in
separate dense host arrays; feature ids 0..m_num-1 are numerical,
m_num..m-1 categorical.  Columns stay host-side numpy until a fit moves
them to its device once.

Out-of-core training reads a `RowSource` instead: the bit-packed bin
cache of a numeric-only dataset, in host memory (`ArrayRowSource`) or
memory-mapped from disk (`MemmapRowSource`), handed out one row block at a
time.  The cache is the source and never lives on the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import random
import time
from typing import Sequence

import numpy as np

logger = logging.getLogger("repro_torch.core.stream")


@dataclasses.dataclass
class TabularDataset:
    """A dataset of n rows: numerical (f32) and categorical (i32) columns."""

    num: np.ndarray             # (n, m_num) float32
    cat: np.ndarray             # (n, m_cat) int32, values in [0, arity_j)
    labels: np.ndarray          # (n,) int32 (classification) / float32 (regression)
    arities: tuple[int, ...]    # per categorical column
    num_classes: int = 2        # ignored for regression
    task: str = "classification"  # or "regression"

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    @property
    def m_num(self) -> int:
        return int(self.num.shape[1]) if self.num.size else 0

    @property
    def m_cat(self) -> int:
        return int(self.cat.shape[1]) if self.cat.size else 0

    @property
    def m(self) -> int:
        return self.m_num + self.m_cat

    @property
    def max_arity(self) -> int:
        return max(self.arities) if self.arities else 0

    def validate(self) -> None:
        assert self.num.ndim == 2 and self.cat.ndim == 2
        assert self.num.shape[0] == self.cat.shape[0] == self.labels.shape[0]
        assert len(self.arities) == self.m_cat
        if self.task == "classification":
            assert np.issubdtype(self.labels.dtype, np.integer)

    def quantize(self, num_bins: int) -> tuple[np.ndarray, np.ndarray]:
        """PLANET-style threshold buckets for `split_mode="hist"`.

        Presorts on the CPU and buckets every numeric column into <=
        num_bins equi-depth buckets.  Returns numpy (bin_of (m_num, n)
        uint8 for <= 256 bins, uint16 past; edges (m_num, num_bins)
        float32), both empty without numeric columns: pre-quantized state
        for `tree.build_forest(bin_of=, bin_edges=)`.  The reference's
        `TabularDataset.quantize` gives the same arrays.
        """
        import torch
        from repro_torch.core import presort
        if not self.m_num:
            return (np.zeros((0, self.n),
                             np.uint8 if num_bins <= 256 else np.uint16),
                    np.zeros((0, num_bins), np.float32))
        num = torch.as_tensor(self.num)
        sorted_vals = presort.gather_sorted(num,
                                            presort.presort_columns(num))
        bin_of, edges = presort.quantize(num, sorted_vals, num_bins)
        return bin_of.numpy(), edges.numpy()


def from_numpy(
    num: np.ndarray | None,
    cat: np.ndarray | None,
    labels: np.ndarray,
    arities: Sequence[int] | None = None,
    task: str = "classification",
) -> TabularDataset:
    n = labels.shape[0]
    num = np.zeros((n, 0), np.float32) if num is None else np.asarray(num, np.float32)
    cat = np.zeros((n, 0), np.int32) if cat is None else np.asarray(cat, np.int32)
    if arities is None:
        arities = tuple(int(cat[:, j].max()) + 1 if n else 2
                        for j in range(cat.shape[1]))
    if task == "classification":
        labels = np.asarray(labels, np.int32)
        num_classes = int(labels.max()) + 1 if n else 2
    else:
        labels = np.asarray(labels, np.float32)
        num_classes = 0
    ds = TabularDataset(
        num=num, cat=cat, labels=labels,
        arities=tuple(int(a) for a in arities),
        num_classes=max(num_classes, 2), task=task)
    ds.validate()
    return ds


# ---------------------------------------------------------------------------
# Out-of-core row sources
# ---------------------------------------------------------------------------
#
# In hist mode the bit-packed bin cache is the only per-row numeric state a
# level reads, so a fit can stream fixed-shape row blocks of (bins, labels,
# weights, leaf ids) through a table accumulator instead of holding (m_num,
# n) on the device.  A `RowSource` owns the host-resident pieces — the bin
# cache, the int32 labels and the float32 edges — and hands out column
# blocks; the streamed driver (`tree.build_forest_streamed`) owns the bag
# weights and leaf ids.

class StreamReadError(OSError):
    """A chunk read kept failing after the retry budget.

    Raised by `read_with_retry` once every attempt has failed; the streamed
    driver writes its held level snapshot before letting it escape, so a
    resume restarts at the last completed level."""


class CacheIntegrityError(RuntimeError):
    """An on-disk bin cache disagrees with its sidecar metadata: a
    truncated, re-quantized or swapped cache would otherwise train wrong
    trees without a word."""


def read_with_retry(fn, *args, attempts: int = 4, base_delay: float = 0.05,
                    max_delay: float = 2.0, jitter: float = 0.5,
                    sleep=time.sleep):
    """Call `fn(*args)`, retrying transient `OSError`s with backoff.

    Delays grow exponentially from `base_delay` up to `max_delay`, times
    up to `jitter` of random extra.  Each failure logs a warning; the last
    raises `StreamReadError`, chained to the cause.  Retrying cannot change
    a fit: `bins_block` and `bins_take` are pure reads.  An inner
    `StreamReadError` is not retried, and `CacheIntegrityError` is no
    `OSError`, so both propagate at once."""
    for attempt in range(1, max(1, int(attempts)) + 1):
        try:
            return fn(*args)
        except StreamReadError:
            raise
        except OSError as e:
            if attempt >= attempts:
                raise StreamReadError(
                    f"stream read failed after {attempts} attempts: "
                    f"{getattr(fn, '__qualname__', fn)!s}: {e}") from e
            delay = min(max_delay, base_delay * (2.0 ** (attempt - 1)))
            delay *= 1.0 + jitter * random.random()
            logger.warning(
                "transient stream read failure (attempt %d/%d): %s — "
                "retrying in %.3fs", attempt, attempts, e, delay)
            sleep(delay)


class RowSource:
    """Host-resident binned rows for streamed hist training.

    A backend provides `bins_block(lo, hi)` (a contiguous row range) and
    `bins_take(idx)` (a gather, read once host-side pruning has compacted
    the active rows), each as an (m_num, rows) packed host array.  Only
    hist mode streams: exact mode needs the full presort.  The `retry_*`
    knobs are the budget `tree.build_forest_streamed` gives
    `read_with_retry` for every chunk read."""

    retry_attempts: int = 4
    retry_base_delay: float = 0.05
    retry_max_delay: float = 2.0
    retry_sleep = staticmethod(time.sleep)

    def __init__(self, edges: np.ndarray, labels: np.ndarray, *,
                 num_classes: int, task: str = "classification",
                 chunk_size: int = 1 << 16):
        self.edges = np.ascontiguousarray(edges, np.float32)   # (m_num, B)
        self.labels = np.ascontiguousarray(labels)             # (n,)
        self.num_classes = int(num_classes)
        self.task = task
        self.chunk_size = int(chunk_size)
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    @property
    def m_num(self) -> int:
        return int(self.edges.shape[0])

    @property
    def num_bins(self) -> int:
        return int(self.edges.shape[1])

    def bins_block(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the bin cache: (m_num, hi - lo) packed."""
        raise NotImplementedError

    def bins_take(self, idx: np.ndarray) -> np.ndarray:
        """Rows `idx` of the bin cache: (m_num, len(idx)) packed."""
        raise NotImplementedError


class ArrayRowSource(RowSource):
    """A RowSource over an in-memory (m_num, n) bin cache."""

    def __init__(self, bins: np.ndarray, edges: np.ndarray,
                 labels: np.ndarray, **kw):
        super().__init__(edges, labels, **kw)
        self.bins = np.ascontiguousarray(bins)
        if self.bins.shape != (self.m_num, self.n):
            raise ValueError(f"bins shape {self.bins.shape}, expected "
                             f"(m_num, n) = ({self.m_num}, {self.n})")

    @classmethod
    def from_dataset(cls, ds: TabularDataset, num_bins: int,
                     chunk_size: int | None = None) -> "ArrayRowSource":
        """A streamable source of a numeric-only dataset, quantized by
        `TabularDataset.quantize`, the in-memory fit's recipe: the same
        edges, so the same trees."""
        if ds.m_cat:
            raise ValueError("streaming sources are numeric-only")
        bins, edges = ds.quantize(num_bins)
        kw = {} if chunk_size is None else {"chunk_size": chunk_size}
        return cls(bins, edges, np.asarray(ds.labels),
                   num_classes=ds.num_classes, task=ds.task, **kw)

    def bins_block(self, lo: int, hi: int) -> np.ndarray:
        return self.bins[:, lo:hi]

    def bins_take(self, idx: np.ndarray) -> np.ndarray:
        return self.bins[:, idx]


class MemmapRowSource(RowSource):
    """A RowSource over an on-disk bin cache: a row-major (n, m_num) `.npy`
    beside a `<path>.meta.json` sidecar, the reference's format (a cache
    built by either package opens in the other).

    Row-major, so a chunk of rows is one contiguous file range;
    `bins_block` reads it and transposes it to (m_num, rows) on the host.
    `build` makes the cache from a chunked float stream (three radix-select
    passes for the edges, one binning pass), so no full float column ever
    exists in memory."""

    def __init__(self, path, edges: np.ndarray, labels: np.ndarray, **kw):
        super().__init__(edges, labels, **kw)
        self.path = os.fspath(path)
        self._mm = None

    @staticmethod
    def meta_path(path) -> str:
        return f"{os.fspath(path)}.meta.json"

    def _expected_meta(self) -> dict:
        return {
            "format_version": 1,
            "n": self.n,
            "m_num": self.m_num,
            "dtype": np.dtype(np.uint8 if self.num_bins <= 256
                              else np.uint16).name,
            "num_bins": self.num_bins,
            "edges_sha256": hashlib.sha256(self.edges.tobytes()).hexdigest(),
        }

    def _verify_cache(self, mm: np.ndarray) -> None:
        """Check the cache against its sidecar before the first read.

        A cache without a sidecar (older or hand-built) gets the shape
        check alone and a warning; a truncated file, a sidecar that
        disagrees, or a cache rewritten at another width raises
        `CacheIntegrityError`."""
        if mm.shape != (self.n, self.m_num):
            raise CacheIntegrityError(
                f"bin cache {self.path!r} has shape {tuple(mm.shape)}, "
                f"expected (n, m_num) = ({self.n}, {self.m_num}): the file "
                f"is truncated or belongs to another dataset")
        mp = self.meta_path(self.path)
        if not os.path.exists(mp):
            # `build` writes the sidecar last, so this is also what a
            # build killed mid-binning leaves behind
            logger.warning(
                "bin cache %s has no sidecar metadata (%s); its integrity "
                "cannot be verified, rebuild it with MemmapRowSource.build",
                self.path, mp)
            return
        try:
            with open(mp) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CacheIntegrityError(
                f"unreadable bin-cache sidecar {mp!r}: {e}") from e
        expect = self._expected_meta()
        bad = [k for k in expect if meta.get(k) != expect[k]]
        if np.dtype(mm.dtype).name != meta.get("dtype"):
            bad.append("dtype(file)")
        if bad:
            raise CacheIntegrityError(
                f"bin cache {self.path!r} disagrees with its sidecar {mp!r} "
                f"(mismatched: {', '.join(bad)}): the cache was rebuilt, "
                f"truncated or swapped since it was built; rebuild it with "
                f"MemmapRowSource.build")

    def _cache(self) -> np.ndarray:
        if self._mm is None:
            try:
                mm = np.load(self.path, mmap_mode="r")
            except (OSError, ValueError) as e:
                raise CacheIntegrityError(
                    f"bin cache {self.path!r} does not open as a .npy "
                    f"memmap: {e}") from e
            self._verify_cache(mm)
            self._mm = mm
        return self._mm

    def bins_block(self, lo: int, hi: int) -> np.ndarray:
        return np.ascontiguousarray(self._cache()[lo:hi].T)

    def bins_take(self, idx: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(self._cache()[idx].T)

    @classmethod
    def build(cls, chunks, n: int, labels: np.ndarray, *, num_bins: int,
              path, num_classes: int | None = None,
              task: str = "classification",
              chunk_size: int = 1 << 16) -> "MemmapRowSource":
        """Quantize and bin a chunked float stream straight to disk.

        `chunks` is a callable returning a fresh iterator of (c, m_num)
        float32 row blocks in row order; it is called four times (three
        edge passes, one binning pass).  Host memory stays at one block
        plus O(m_num · num_bins).  The sidecar is written last and
        atomically, so a build killed midway leaves a cache without one.
        """
        from repro_torch.core import atomicio, presort
        first = next(iter(chunks()))
        m_num = int(first.shape[1])
        edges = presort.streaming_quantile_edges(chunks, n, m_num, num_bins)
        mm = np.lib.format.open_memmap(
            os.fspath(path), mode="w+", shape=(n, m_num),
            dtype=np.uint8 if num_bins <= 256 else np.uint16)
        lo = 0
        for block in chunks():
            c = block.shape[0]
            mm[lo:lo + c] = presort.bin_block(block, edges).T
            lo += c
        if lo != n:
            raise ValueError(f"the chunk stream covered {lo} rows, not {n}")
        mm.flush()
        del mm
        labels = np.asarray(labels)
        if num_classes is None:
            num_classes = (int(labels.max()) + 1
                           if task == "classification" else 0)
        src = cls(path, edges, labels, num_classes=max(num_classes, 2),
                  task=task, chunk_size=chunk_size)
        atomicio.atomic_write_json(cls.meta_path(path), src._expected_meta())
        return src

    @classmethod
    def from_numpy(cls, num: np.ndarray, labels: np.ndarray, *,
                   num_bins: int, path, chunk_size: int = 1 << 16,
                   **kw) -> "MemmapRowSource":
        """`build` over an (n, m_num) array, which may itself be a
        memmap; `chunk_size` is also the block the build reads."""
        n = int(num.shape[0])

        def chunks():
            for lo in range(0, n, chunk_size):
                yield np.asarray(num[lo:lo + chunk_size], np.float32)
        return cls.build(chunks, n, labels, num_bins=num_bins, path=path,
                         chunk_size=chunk_size, **kw)
