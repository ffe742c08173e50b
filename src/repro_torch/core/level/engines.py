"""SplitEngine protocol + the local engines, ported from
`repro.core.level.engines`.

A `SplitEngine` answers ONE question per depth level: "for every open
leaf of every tree in the batch, what is the best split on my features?"
— the paper's supersplit query.  The level plan (plan.py) owns everything
around that answer (candidate draw, winner argmax, condition eval,
reassignment).  Engines see the whole tree batch at once, with an
explicit leading tree axis T:

    numeric engines:      (gains (T, m_num, L+1), thresholds (T, m_num, L+1),
                           the level's tables (T, m_num, L+1, B, S) for a
                           histogram engine, else None)
    categorical engines:  (gains (T, m_cat, L+1), left-masks (T, m_cat, L+1, V))

Engines are frozen dataclasses; choosing one chooses a code path.  The
table-building engines (histogram and categorical) build through the
kernel wrappers whatever their `backend` label: a wrapper takes its plain
version only for CPU tensors, so on the card no engine bypasses a kernel.
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
    `num_cols[j, k]` / `cat_cols[j, k]` / `bin_of[j, k]`.

    The last four fields are the histogram-subtraction state, present only
    when the plan carries tables (`st.subtract`): `prev_tables` holds the
    previous level's per-leaf tables (indexed by the previous level's leaf
    ids), and the three per-leaf maps relate the CURRENT frontier to it —
    `parent_of[t, l]` is l's parent leaf id at the previous level,
    `sib_of[t, l]` its sibling's current id, `slot_of[t, l]` its packed
    build slot (0 = table derived by subtraction).
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
    bin_of: torch.Tensor = None       # (m_num, n) packed hist bucket ids
    prev_tables: torch.Tensor = None  # (T, m_num, Wprev, B, S) previous level
    parent_of: torch.Tensor = None    # (T, L+1) parent leaf id at prev level
    sib_of: torch.Tensor = None       # (T, L+1) sibling's current leaf id
    slot_of: torch.Tensor = None      # (T, L+1) packed build slot, 0 = derive


class LevelStatics(NamedTuple):
    """The static config shared by every engine call.

    `subtract` is the per-level setting the plan fills in: the inputs
    carry a valid previous level (prev_tables + maps), so only build-slot
    leaves are scattered and their siblings derive as parent − sibling.
    """
    m_num: int
    m_cat: int
    max_arity: int
    num_classes: int
    impurity: str
    task: str
    min_records: float
    num_bins: int = 255
    subtract: bool = False


class SplitEngine:
    """Base protocol.  Subclasses are frozen dataclasses."""

    kind: str = "numeric"       # "numeric" | "categorical"
    needs_bins: bool = False    # True: reads the hist bin cache (hist mode)
    bin_cut_thresholds: bool = False  # True: thresholds are BIN INDICES,
                                # decoded on the host; conditions are
                                # evaluated on the bin cache
    carries_tables: bool = False  # True: its tables can seed the next
                                # level's subtraction (st.subtract)

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
            return (*kops.split_scan_supersplit(
                inp.sorted_vals, inp.sorted_idx, inp.leaf_of, inp.w,
                inp.labels, cand, inp.totals, st.impurity, st.task,
                st.min_records), None)
        if self.backend == "scan":
            return (*split_scan.split_scan_plain(
                inp.sorted_vals, inp.sorted_idx, inp.leaf_of, inp.w,
                inp.labels.to(torch.float32), cand, inp.totals,
                impurity=st.impurity, task=st.task,
                min_records=st.min_records), None)
        raise NotImplementedError(
            f"ExactNumeric backend {self.backend!r} is not ported (ROADMAP: "
            f"numeric segment backend)")


# ---------------------------------------------------------------------------
# Histogram mode
# ---------------------------------------------------------------------------

def _hist_build_rows(inp, subtract):
    """The per-row scatter slots (T, n) a table build reads.

    Plain mode scatters every row under its raw leaf id.  Subtraction mode
    remaps rows through `slot_of`: the rows of derive-slot leaves land in
    the discarded slot 0.  The reference also gathers the build rows into
    an n//2 buffer first; the port does not, since the `feat_hist` kernel
    skips a row whose slot is 0 in every tree before its column loop.
    Classification tables are integer counts, so the tables are the same
    either way.
    """
    if not subtract:
        return inp.leaf_of
    return torch.gather(inp.slot_of, 1, inp.leaf_of.long())


def _expand_subtracted(packed, prev_tables, parent_of, sib_of, slot_of):
    """Full-width tables from packed build tables + the parent recurrence.

    packed (T, m, Wb, B, S) build-slot tables; prev_tables (T, m, Wprev,
    B, S); maps (T, L+1).  Returns (T, m, L+1, B, S): build leaves take
    their packed slot and every derive leaf is `parent − sibling` — exact
    for classification (integer-valued counts), which is why the plan
    enables subtraction only there.
    """
    T = packed.shape[0]
    tt = torch.arange(T, device=packed.device)[:, None]
    pk = packed.transpose(1, 2)                           # (T, Wb, m, B, S)
    from_build = pk[tt, slot_of.long()]                   # (T, L+1, m, B, S)
    sib = pk[tt, torch.gather(slot_of, 1, sib_of.long()).long()]
    derived = prev_tables.transpose(1, 2)[tt, parent_of.long()] - sib
    out = torch.where((slot_of > 0)[..., None, None, None], from_build,
                      derived)
    return out.transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class HistNumeric(SplitEngine):
    """PLANET-style histogram numeric search.

    Reads ONLY the bit-packed bin cache (`bin_of`, uint8/uint16): per-leaf
    (bin × stat) tables for all columns are built in one pass by the
    `feat_hist` kernel (its plain version, `splits.feature_count_tables`,
    on CPU tensors), and `splits.best_numeric_split_histogram` scores the
    bucket boundaries, returning BIN INDICES the host decodes against the
    float edges, and the level's tables.  Under `st.subtract` only the
    build child of each split is scattered and its sibling derives as
    parent − sibling from the previous level's tables.  `backend` is the
    reference's label (its "kernel" and "segment" give the same tables)
    and picks no path here.  The reference's out-of-core `stream_*`
    methods belong to the streaming slice (ROADMAP: out-of-core and fault
    tolerance).
    """
    backend: str = "segment"

    needs_bins = True
    bin_cut_thresholds = True
    carries_tables = True

    def supersplits(self, inp, st, Lp, cand):
        Wb = Lp // 2 + 1 if st.subtract else Lp + 1
        with record_function("level.hist_tables"):
            packed = kops.feature_tables(
                inp.bin_of, _hist_build_rows(inp, st.subtract), inp.w,
                inp.labels, B=st.num_bins, W=Wb, task=st.task,
                num_classes=st.num_classes)
            if st.subtract:
                tables = _expand_subtracted(packed, inp.prev_tables,
                                            inp.parent_of, inp.sib_of,
                                            inp.slot_of)
            else:
                tables = packed
        with record_function("level.hist_score"):
            g, c = splits.best_numeric_split_histogram(
                tables, cand, st.impurity, st.task, st.min_records)
        return g, c, tables


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
    + Breiman ordering.  The tables come from the `cat_hist` kernel (its
    plain version, `splits.categorical_count_tables`, on CPU tensors);
    `backend` is the reference's label and picks no path here."""
    backend: str = "kernel"

    kind = "categorical"

    def supersplits(self, inp, st, Lp, cand):
        with record_function("level.cat_tables"):
            tables = kops.categorical_tables(
                inp.cat_cols, inp.leaf_of, inp.w, inp.labels,
                V=st.max_arity, Lp=Lp, task=st.task,
                num_classes=st.num_classes)
        with record_function("level.cat_breiman"):
            return _score_tables(tables, cand, st)
