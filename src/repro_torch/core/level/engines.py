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
from typing import Callable, NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.core import splits
from repro_torch.kernels import breiman, cat_hist
from repro_torch.kernels import ops as kops
from repro_torch.kernels import split_scan

# The segment scorers run over column chunks of at most this many
# (column, row, stat) elements.
_SEGMENT_CHUNK_ELEMS = 1 << 26


class LevelInputs(NamedTuple):
    """The level state handed to engines (T = trees in the batch).

    The shared read-only fields are column-major: row k of column j is
    `num_cols[j, k]` / `cat_cols[j, k]` / `bin_of[j, k]`.

    `ord_idx` and `row_counts` are the `segment` backend's leaf-ordered
    layout, present only when the plan keeps it (`plan.use_ord`):
    `ord_idx[t, j]` lists column j's rows of tree t grouped by leaf (ids
    ascending, closed rows first) and value-ascending inside each leaf,
    and `row_counts[t, l]` counts leaf l's rows, closed and out-of-bag
    ones included.  The presort is not passed with it.

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
    sorted_vals: torch.Tensor   # (m_num, n) presorted values (or None)
    sorted_idx: torch.Tensor    # (m_num, n) presorted row ids (or None)
    leaf_of: torch.Tensor       # (T, n) leaf id per row, 0 = closed
    w: torch.Tensor             # (T, n) bag weights
    stats: torch.Tensor         # (T, n, S) row stats
    totals: torch.Tensor        # (T, L+1, S) per-leaf stat totals
    bin_of: torch.Tensor = None       # (m_num, n) packed hist bucket ids
    ord_idx: torch.Tensor = None      # (T, m_num, n) leaf order (int32)
    row_counts: torch.Tensor = None   # (T, L+1) rows per leaf, ord layout
    prev_tables: torch.Tensor = None  # (T, m_num, Wprev, B, S) previous level
    parent_of: torch.Tensor = None    # (T, L+1) parent leaf id at prev level
    sib_of: torch.Tensor = None       # (T, L+1) sibling's current leaf id
    slot_of: torch.Tensor = None      # (T, L+1) packed build slot, 0 = derive
    bin_edges: torch.Tensor = None    # (m_num, B) float edges (`pass_edges`)


class LevelStatics(NamedTuple):
    """The static config shared by every engine call.

    `subtract` is the per-level setting the plan fills in: the inputs
    carry a valid previous level (prev_tables + maps), so only build-slot
    leaves are scattered and their siblings derive as parent − sibling.
    `m_prime` bounds a leaf's candidate columns, which sizes the
    categorical engine's compact tables.
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
    m_prime: int = 0            # candidate columns a leaf draws (0: all)


class SplitEngine:
    """Base protocol.  Subclasses are frozen dataclasses."""

    kind: str = "numeric"       # "numeric" | "categorical"
    uses_ord: bool = False      # True: reads the incremental leaf order
    needs_bins: bool = False    # True: reads the hist bin cache (hist mode)
    bin_cut_thresholds: bool = False  # True: thresholds are BIN INDICES,
                                # decoded on the host; conditions are
                                # evaluated on the bin cache
    carries_tables: bool = False  # True: its tables can seed the next
                                # level's subtraction (st.subtract)
    exact_counts: bool = False  # True: it sums classification counts as
                                # integers (exact to 2^31); else in float32,
                                # exact only below 2^24 (`plan.count_limit`)

    def supersplits(self, inp: LevelInputs, st: LevelStatics, Lp: int,
                    cand: torch.Tensor):
        """cand is (T, m, L+1) bool (leaf 0 = False)."""
        raise NotImplementedError

    def row_shards(self) -> int:
        """How many row shards the engine splits n into: n must stay
        divisible by it (a mesh engine's `data` axis; 1 on one device)."""
        return 1

    # -- out-of-core streaming ----------------------------------------------
    #
    # A streaming hist engine splits its table build into a chunk
    # recurrence: `stream_init` makes the level's accumulator,
    # `stream_accumulate` adds one row chunk (once per chunk) and
    # `stream_finalize` turns the accumulator into the (T, m_num, L+1, B, S)
    # tables the scorer reads (once per level).  Classification tables hold
    # integer-valued float32 counts, exact below 2^24 (a tree's in-bag
    # weight is held there, `plan.count_limit`), so the chunked sum equals
    # one pass whatever the chunk boundaries.

    supports_stream: bool = False

    def stream_init(self, T: int, st: LevelStatics, Lp: int,
                    device: torch.device):
        """The zero accumulator of one level of T trees."""
        raise NotImplementedError

    def stream_accumulate(self, acc, bins, leaf, w, labels, st: LevelStatics,
                          Lp: int):
        """acc plus the tables of one chunk: bins (m, c) packed; leaf and
        w (T, c); labels (c,)."""
        raise NotImplementedError

    def stream_finalize(self, acc):
        """The accumulator as merged (T, m_num, Lp+1, B, S) tables (a mesh
        engine: the tables of its own columns)."""
        raise NotImplementedError

    def score_tables(self, tables, cand, st: LevelStatics):
        """The (gains, bin cuts) of `stream_finalize`'s tables, each (T,
        m_num, Lp+1); cand (T, m_num, Lp+1)."""
        raise NotImplementedError


def _column_chunk(m: int, n: int, S: int) -> int:
    """Columns per chunk of a segment scorer: its (columns, n, S)
    temporaries stay below `_SEGMENT_CHUNK_ELEMS` elements each."""
    return max(1, min(m, _SEGMENT_CHUNK_ELEMS // max(1, n * S)))


def _segment_supersplits(sorted_vals, sorted_idx, leaf_of, w, stats, cand,
                         Lp, impurity, task, min_records):
    """The `segment` backend over the presort, without the leaf-ordered
    layout: each column counting-sorted by leaf and scored on its own
    per-leaf totals (`best_numeric_split_segment`), in column chunks.

    sorted_vals/sorted_idx (m, n); leaf_of/w (T, n); stats (T, n, S);
    cand (T, m, Lp+1).  Returns gains and thresholds, each (T, m, Lp+1).
    """
    T, n = leaf_of.shape
    m = sorted_idx.shape[0]
    gains = torch.empty((T, m, Lp + 1), dtype=torch.float32,
                        device=leaf_of.device)
    thr = torch.empty_like(gains)
    step = _column_chunk(m, n, stats.shape[-1])
    for t in range(T):
        for j0 in range(0, m, step):
            j1 = min(m, j0 + step)
            si = sorted_idx[j0:j1].long()
            gains[t, j0:j1], thr[t, j0:j1] = splits.best_numeric_split_segment(
                sorted_vals[j0:j1], leaf_of[t][si], w[t][si], stats[t][si],
                cand[t, j0:j1], Lp, impurity, task, min_records)
    return gains, thr


def _leaf_ordered_supersplits(inp, st, Lp, cand):
    """The `segment` backend over the leaf-ordered layout: every column of
    every tree, in column chunks.  Classification scores against the
    level's shared totals (exact: integer bag counts); regression reduces
    each column's own totals, as the reference does."""
    T, m, n = inp.ord_idx.shape
    S = inp.stats.shape[-1]
    gains = torch.empty((T, m, Lp + 1), dtype=torch.float32,
                        device=inp.leaf_of.device)
    thr = torch.empty_like(gains)
    step = _column_chunk(m, n, S)
    for t in range(T):
        lf_pos = inp.leaf_of[t][inp.ord_idx[t, 0].long()]   # every column's
        open_pos = lf_pos > 0
        tot = inp.totals[t] if st.task == "classification" else None
        for j0 in range(0, m, step):
            j1 = min(m, j0 + step)
            oi = inp.ord_idx[t, j0:j1].long()
            g, h = splits.best_numeric_split_leaf_ordered(
                torch.gather(inp.num_cols[j0:j1], 1, oi), lf_pos,
                (inp.w[t][oi] > 0) & open_pos, inp.stats[t][oi],
                cand[t, j0:j1], Lp, st.impurity, st.task, st.min_records,
                totals=tot, row_counts=inp.row_counts[t])
            gains[t, j0:j1], thr[t, j0:j1] = g, h
    return gains, thr


@dataclasses.dataclass(frozen=True)
class ExactNumeric(SplitEngine):
    """The paper's midpoint-exhaustive numeric search.  Every backend
    gives the same trees.

    backend = "segment" (the reference's default) reads the incrementally
    kept (leaf, value)-sorted layout when the driver hands it
    (`inp.ord_idx`), and else counting-sorts each presorted column by
    leaf; its prefix sums, cummax and segment reductions are plain
    PyTorch on any device.  "kernel" runs the `split_scan` kernel (its
    plain version on CPU tensors); "scan" the plain Alg. 1 recurrence.
    Every backend reads the level's int32 class totals; `kernel` and
    `scan` keep int32 prefixes, `segment` float64 ones: the left and right
    counts are exact, and each is rounded to float32 once, for the gains,
    so the three give the same trees at any row count.
    """
    backend: str = "segment"

    exact_counts = True

    @property
    def uses_ord(self) -> bool:
        return self.backend == "segment"

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
        if self.backend != "segment":
            raise ValueError(f"unknown exact backend {self.backend!r}")
        with record_function("level.segment_score"):
            if inp.ord_idx is not None:
                return (*_leaf_ordered_supersplits(inp, st, Lp, cand), None)
            return (*_segment_supersplits(
                inp.sorted_vals, inp.sorted_idx, inp.leaf_of, inp.w,
                inp.stats, cand, Lp, st.impurity, st.task,
                st.min_records), None)


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
    and picks no path here.  Out of core, `stream_accumulate` builds each
    row chunk's tables through the same `feat_hist` wrapper, with the
    chunk's current leaf ids as slots, and adds them up.
    """
    backend: str = "segment"

    needs_bins = True
    bin_cut_thresholds = True
    carries_tables = True
    supports_stream = True

    def stream_init(self, T, st, Lp, device):
        S = kops.stat_dim(st.num_classes, st.task)
        return torch.zeros((T, st.m_num, Lp + 1, st.num_bins, S),
                           dtype=torch.float32, device=device)

    def stream_accumulate(self, acc, bins, leaf, w, labels, st, Lp):
        with record_function("level.hist_tables"):
            return acc.add_(kops.feature_tables(
                bins, leaf, w, labels, B=st.num_bins, W=Lp + 1,
                task=st.task, num_classes=st.num_classes))

    def stream_finalize(self, acc):
        return acc

    def score_tables(self, tables, cand, st):
        with record_function("level.hist_score"):
            return splits.best_numeric_split_histogram(
                tables, cand, st.impurity, st.task, st.min_records)

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
        return (*self.score_tables(tables, cand, st), tables)


def _score_tables(tables, cand, st, slot=None):
    """Breiman scoring of the (K, V, S) tables `kops.categorical_tables`
    built at `slot` (`cat_hist.candidate_slots(cand)`; None: one table per
    (tree, column, leaf), in order): classification
    through the `breiman` kernel wrapper (its plain version on CPU
    tensors); regression's float64 prefix sums keep their sequential order
    in the plain version on every device."""
    if st.task == "classification":
        return kops.breiman_splits(tables, cand, st.impurity, st.min_records,
                                   slot=slot)
    return breiman.breiman_plain(tables, cand, slot, impurity=st.impurity,
                                 task=st.task, min_records=st.min_records)


@dataclasses.dataclass(frozen=True)
class CategoricalTable(SplitEngine):
    """Exact categorical search from (leaf × category × stat) count tables
    + Breiman ordering.  The tables come from the `cat_hist` kernel and
    classification tables are scored by the `breiman` kernel (their plain
    versions, `splits.categorical_count_tables` and
    `splits.best_categorical_split_from_table`, on CPU tensors); `backend`
    is the reference's label and picks no path here.  Classification
    tables are int32 class counts, exact to 2^31.

    Only the candidate (tree, column, leaf)s get a table: the slot map of
    `cand` (`cat_hist.candidate_slots`, made once a level) goes to
    cat_hist, which builds the compact (K, V, S) tables, K = T·(L+1)·
    min(m′, m_cat), and to the scorer, which reads each candidate's there.
    Where m′ >= m_cat, K is the full count; the trees are those of a table
    for every (tree, column, leaf) either way (the same counts in the
    tables that are read)."""
    backend: str = "kernel"

    kind = "categorical"
    exact_counts = True

    def supersplits(self, inp, st, Lp, cand):
        with record_function("level.cat_tables"):
            slot = cat_hist.candidate_slots(cand)
            tables = kops.categorical_tables(
                inp.cat_cols, inp.leaf_of, inp.w, inp.labels,
                V=st.max_arity, Lp=Lp, task=st.task,
                num_classes=st.num_classes, slot=slot,
                m_prime=st.m_prime or None)
        with record_function("level.cat_breiman"):
            return _score_tables(tables, cand, st, slot)


@dataclasses.dataclass(frozen=True, eq=False)   # identity hash, as the
class LegacyFn(SplitEngine):                    # reference's
    """Adapter for a bare `supersplit_fn` closure (the pre-SplitEngine
    API).  Per-tree only: `RandomForest.fit` warns and routes these to
    `tree.build_tree`, one tree at a time, because an arbitrary closure
    sees ONE tree's arrays.

    The closure is called in the reference's argument order,

      sorted:  fn(sorted_vals, sorted_idx, leaf_of, w, stats, cand, Lp,
                  impurity, task, min_records)
      hist:    fn(bin_of, bin_edges, leaf_of, w, stats, cand, Lp,
                  impurity, task, min_records)

    with leaf_of and w (n,), stats (n, S) and cand (m_num, Lp+1): the
    level's leading tree axis (T = 1) is dropped before the call and put
    back on its (gains, thresholds), each (m_num, Lp+1).  A hist closure
    gets the float bucket edges and returns float thresholds, so the
    level evaluates its conditions on the raw columns."""
    fn: Callable
    hist: bool = False          # hist-mode signature (bin_of, bin_edges, ...)

    @property
    def needs_sorted(self) -> bool:
        return not self.hist

    @property
    def needs_bins(self) -> bool:       # type: ignore[override]
        return self.hist

    def supersplits(self, inp, st, Lp, cand):
        if inp.leaf_of.shape[0] != 1:
            raise ValueError("a LegacyFn closure scores one tree at a time")
        rows = (inp.leaf_of[0], inp.w[0], inp.stats[0], cand[0], Lp,
                st.impurity, st.task, st.min_records)
        if self.hist:
            g, thr = self.fn(inp.bin_of, inp.bin_edges, *rows)
        else:
            g, thr = self.fn(inp.sorted_vals, inp.sorted_idx, *rows)
        return g[None], thr[None], None


def resolve_engine(engine, supersplit_fn, hist: bool):
    """The numeric engine of a fit given `engine=` and the reference's
    legacy `supersplit_fn=`: a `SplitEngine` passed as `supersplit_fn` is
    taken as the engine, a bare closure is wrapped in `LegacyFn` (the hist
    signature when `hist`).  Passing both raises ValueError."""
    if supersplit_fn is None:
        return engine
    if engine is not None:
        raise ValueError(
            "pass either engine= (a SplitEngine) or supersplit_fn=, "
            "not both — one of them would be silently ignored")
    if isinstance(supersplit_fn, SplitEngine):
        return supersplit_fn
    return LegacyFn(fn=supersplit_fn, hist=hist)
