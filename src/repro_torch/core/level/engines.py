"""SplitEngine protocol + the local engines, ported from
`repro.core.level.engines`.

A `SplitEngine` answers ONE question per depth level: "for every open
leaf of every tree in the batch, what is the best split on my features?"
— the paper's supersplit query.  The level plan (plan.py) owns everything
around that answer (candidate draw, winner argmax, condition eval,
reassignment).  Engines see the whole tree batch at once, with an
explicit leading tree axis T:

    numeric engines:      (gains (T, m_num, L+1), thresholds (T, m_num, L+1))
    categorical engines:  (gains (T, m_cat, L+1), left-masks (T, m_cat, L+1, V))

Engines are frozen dataclasses; choosing one chooses a code path.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.core import splits
from repro_torch.kernels import ops as kops
from repro_torch.kernels import split_scan

# Breiman scoring runs over column chunks whose count tables stay below
# this many float32 elements, bounding the sort/cumsum temporaries.
_SCORE_CHUNK_ELEMS = 1 << 27


class LevelInputs(NamedTuple):
    """The level state handed to engines (T = trees in the batch).

    The shared read-only fields are column-major: row k of column j is
    `num_cols[j, k]` / `cat_cols[j, k]`.
    """
    num_cols: torch.Tensor      # (m_num, n) raw numeric columns
    cat_cols: torch.Tensor      # (m_cat, n) raw categorical columns
    labels: torch.Tensor        # (n,) class ids / regression targets
    sorted_vals: torch.Tensor   # (m_num, n) presorted values
    sorted_idx: torch.Tensor    # (m_num, n) presorted row ids (int32)
    leaf_of: torch.Tensor       # (T, n) leaf id per row, 0 = closed
    w: torch.Tensor             # (T, n) bag weights
    stats: torch.Tensor         # (T, n, S) row stats
    totals: torch.Tensor        # (T, L+1, S) per-leaf stat totals


class LevelStatics(NamedTuple):
    """The static config shared by every engine call."""
    m_num: int
    m_cat: int
    max_arity: int
    num_classes: int
    impurity: str
    task: str
    min_records: float


class SplitEngine:
    """Base protocol.  Subclasses are frozen dataclasses."""

    kind: str = "numeric"       # "numeric" | "categorical"

    def supersplits(self, inp: LevelInputs, st: LevelStatics, Lp: int,
                    cand: torch.Tensor):
        """cand is (T, m, L+1) bool (leaf 0 = False)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ExactNumeric(SplitEngine):
    """The paper's midpoint-exhaustive numeric search.

    backend = "kernel" runs the `split_scan` kernel (its plain version on
    CPU tensors); "scan" runs the plain Alg. 1 recurrence on any device.
    Both give the same trees.  The reference's default "segment" backend
    (leaf-ordered layout) is not ported yet (ROADMAP).
    """
    backend: str = "kernel"

    def supersplits(self, inp, st, Lp, cand):
        if self.backend == "kernel":
            return kops.split_scan_supersplit(
                inp.sorted_vals, inp.sorted_idx, inp.leaf_of, inp.w,
                inp.labels, cand, inp.totals, st.impurity, st.task,
                st.min_records)
        if self.backend == "scan":
            return split_scan.split_scan_plain(
                inp.sorted_vals, inp.sorted_idx, inp.leaf_of, inp.w,
                inp.labels.to(torch.float32), cand, inp.totals,
                impurity=st.impurity, task=st.task,
                min_records=st.min_records)
        raise NotImplementedError(
            f"ExactNumeric backend {self.backend!r} is not ported (ROADMAP: "
            f"numeric segment backend)")


def _score_tables(tables, cand, st):
    """Breiman scoring of (T, m, L+1, V, S) tables, in column chunks."""
    T, m, L1, V, S = tables.shape
    per_col = max(1, T * L1 * V * S)
    step = max(1, _SCORE_CHUNK_ELEMS // per_col)
    gains = torch.empty((T, m, L1), dtype=torch.float32,
                        device=tables.device)
    masks = torch.empty((T, m, L1, V), dtype=torch.bool,
                        device=tables.device)
    for j0 in range(0, m, step):
        j1 = min(m, j0 + step)
        g, mk = splits.best_categorical_split_from_table(
            tables[:, j0:j1], cand[:, j0:j1], st.impurity, st.task,
            st.min_records)
        gains[:, j0:j1] = g
        masks[:, j0:j1] = mk
    return gains, masks


@dataclasses.dataclass(frozen=True)
class CategoricalTable(SplitEngine):
    """Exact categorical search from (leaf × category × stat) count tables
    + Breiman ordering; backend="kernel" builds the tables with the
    `cat_hist` kernel, any other backend with the plain scatter."""
    backend: str = "kernel"

    kind = "categorical"

    def supersplits(self, inp, st, Lp, cand):
        with record_function("level.cat_tables"):
            if self.backend == "kernel":
                tables = kops.categorical_tables(
                    inp.cat_cols, inp.leaf_of, inp.w, inp.labels,
                    V=st.max_arity, Lp=Lp, task=st.task,
                    num_classes=st.num_classes)
            else:
                tables = splits.categorical_count_tables(
                    inp.cat_cols, inp.leaf_of, inp.w, inp.stats, Lp,
                    st.max_arity)
        with record_function("level.cat_breiman"):
            return _score_tables(tables, cand, st)
