"""Tabular dataset container (paper §2.1), ported from `repro.core.dataset`.

The paper's datasets mix numerical and categorical columns (Leo: 3
numerical + 69 categorical, arities 2..10'000).  The two groups live in
separate dense host arrays; feature ids 0..m_num-1 are numerical,
m_num..m-1 categorical.  Columns stay host-side numpy until a fit moves
them to its device once.  In memory only: the out-of-core `RowSource` is a
later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


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
